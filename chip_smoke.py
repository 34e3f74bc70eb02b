#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. the device: a CUDA card is required; its name and power limit as
     nvidia-smi prints them;
  2. the build: nvcc compiles zdr_tpu_torch/kernels/csrc/ for sm_90a into
     zdr_tpu_torch/kernels/_build/; ptxas's registers, local bytes (stack
     frame) and spill bytes of the BVH megakernels, the dense direct
     kernels' instantiations (with and without the envmap) and the
     collocated kernels (ptxas_bvh), each without and with the generic
     sampler (kGen: "<name>_gen"), also under "ptxas" in their records;
  3. the sampler probe kernel, bit for bit against the plain sampler: lcg,
     pmj02bn and corrmj at 64 spp, corrmj at 96 and 65 and pmj02bn at 96
     and 65 (the generic instantiation), each timed, with its bound and the
     rejection rounds of the plain permutation;
  4. one path-loop kernel step (n_steps=1) against loop_step at 128x128,
     from the first carry and after 5 steps;
  5. the whole render at 128x128, 16 spp: kernel against plain version;
  6. the main path: the flagship cornell box (pmj02bn, 512x512, 64 spp,
     1024^2 material of 0.5, seed 0) through Scene.render, its launch
     counts, its image against one plain render, its time, and the time
     of the kernel alone and of its plain version on the same tables; the
     launch's shape, registers, local memory, blocks an SM, resident
     threads and waves, and the bound of its counted work (_loop_bound);
  7. the gradient kernel at 128x128, 16 spp, a random 64^2 material and a
     random adjoint, with its launch's tap rows in shared memory and with
     every row in global scratch: against the plain backward (per-channel
     sums within rtol 1e-5; texels whose gradient passes 1e-3 of the
     largest within rtol 1e-4: float atomics sum in a run-dependent order,
     so the two are not bit-exact), and its own radiance bit for bit
     against the forward kernel's render at the same seed;
  8. the path integrator's iteration: the flagship with a material that
     requires grad, loss = image[..., :3].sum(), loss.backward(); the launch
     counts, the gradient finite, nonzero and at phase 7's bars against the
     plain backward; the iteration's time and the gradient kernel's alone
     (medians of 5 after a warm-up), the plain backward's (one run); the
     launch's tap rows in shared memory, block, registers and occupancy;
  9. the trace_interact kernel, full and lite, on 512^2 random rays over
     the cornell box's table and the 962-triangle sphere + quad's: ints
     equal, floats within atol 1e-6 and rtol 1e-6 of the plain version;
 10. the direct kernel at 128x128, 16 spp on both scenes against its plain
     version at phase 5's bar; the direct_grad kernel against the plain
     backward at phase 7's bars, its radiance bit for bit against direct's;
 11. the main path of the direct integrator, the default one: the
     reference's benchmark protocol (tools/bench_reference.py's sphere of
     962 triangles + quad light, camera and 1024^2 material of 0.5; direct
     + MIS, pmj02bn, 512x512, 256 spp) by the dense route
     (accel="bruteforce"), loss = image[..., :3].sum(), loss.backward():
     the launch counts, no plain version called, the gradient finite and
     nonzero; both kernels against their plain versions on the main path's
     own inputs at every 64th lane (direct at phase 10's bar; direct_grad,
     with the iteration's adjoint on those lanes and 0 elsewhere, at phase
     7's bars); the iteration's median, Scene.render's and each kernel's
     alone (CUDA events), its launch's block, and the bound of its counted
     work (_direct_bound) beside its tests-only bound (the early out's
     tests counted up to the place each leaves, by the plain model of it on
     every 256th lane, whose count must equal the kernel's there:
     _early_work); then the same for
     the cornell box at 512x512, 64 spp (the protocol's kernels sweep with
     the early out, the cornell box's without: each instantiation
     runs on a main path); then the protocol by the route accel="auto"
     takes, the BVH, as phase 13 drives the big mesh;
 12. the trace kernels, trace_closest and trace_any (per-ray t_max), on
     262,144 random rays: the dense sweep over the 962-triangle protocol
     scene, the BVH over it and over the big mesh (50,882 triangles); each
     bit for bit against its plain version, with the same counted tests and
     node visits, and timed;
 13. the big-mesh main path (tools/bench_bigmesh.py's sphere of 160 x 160,
     50,880 triangles, over the protocol's quad light of 40, its camera;
     pmj02bn, 512x512, 64 spp, 1024^2 material of 0.5) through Scene.render
     + loss.backward(), for the direct and the path integrator: one launch
     of each BVH kernel and none of the dense ones, no plain version
     called; both BVH kernels against their plain walks on the main path's
     own inputs at every 64th lane for the first CHECK_SAMPLES samples
     (phase 10's and phase 7's bars); the iteration's median, Scene.render's
     and each kernel's alone, with its counted tests and node visits (a
     visit tests both children's boxes: VISIT_OPS);
 14. the sweep variants (the counterparts of the TPU measurement kernels
     under tools/): on the protocol's 962 triangles and 262,144 rays of
     each set (the camera's coherent primaries, incoherent bounce-like
     rays, shadow rays to the light), sweep_variant at every kTile x R,
     woop_sweep and aabb_sweep, each bit for bit against its plain version
     with equal counts (the epilogue modes at phase 9's bar), the MT ones
     also against accel.cu's dense trace kernels; the Woop winners against
     MT's; each timed against floor_probe, an empty kernel-shaped launch
     (a call's time by events around it, and the device's time a call, by a
     CUDA graph of GRAPH_CALLS launches, beside torch.add's taken both
     ways);
     then trace_closest / trace_any through BVHs of leaf width 2, 4, 8 and
     16 on the protocol scene and the big mesh;
 15. the dense-vs-BVH crossover: each integrator's iteration (pmj02bn,
     512x512, 64 spp, 1024^2 material) at eight or nine scene sizes from the
     cornell box to the largest its dense kernels hold, by both routes: the
     images equal bit for bit, the gradients at phase 7's bars, the times
     beside accel/build.DENSE_MAX_TRIS, which they set;
 16. a scene past a block's shared memory in light rows alone (a uv sphere
     of 4512 emissive triangles over a floor) at 128x128, 16 spp by
     accel="auto", both integrators: the BVH kernels with the small tables
     in global memory, against the plain walks at every 8th lane;
 17. the collocated integrator (_slice_main): its main path, the big-mesh
     bench's sphere (tools/bench_bigmesh.py: 160 x 160, 50,880 triangles,
     its camera) at 512x512, 64 spp, 1024^2 material of 0.5, through
     Scene.render + loss.backward() by accel="auto" (the BVH:
     collocated_bvh, collocated_grad_bvh); then tools/gen_golden.py's
     960-triangle sphere by the dense route (collocated, collocated_grad)
     and by the BVH, the two images equal bit for bit; each drive: one
     launch of each of its two kernels and of no other, no plain version
     called, both kernels against their plain versions on its own inputs
     at every 64th lane (the dense route over all samples, the BVH over the
     first CHECK_SAMPLES), the forward bit for bit, the gradient at phase
     7's bars, and timed;
 18. the direct integrator under an envmap: apps/example.py's full-size
     iteration (the 960-triangle sphere under make_test_envmap(256, 512),
     its camera, 512x512, 64 spp, a 512^2 material of 0.5) by accel="auto"
     (direct_env_bvh, direct_grad_env_bvh) and by "bruteforce" (direct_env,
     direct_grad_env, the early out), as phase 17 drives them, the images
     equal bit for bit; then the dense env instantiation without the early
     out on the cornell box under the same envmap (128x128, 16 spp), bit
     for bit against its plain version and its gradient at phase 7's bars;
 19. the path integrator under an envmap (_slice_main): bench.py's
     flagship (cornell box + light @ 15, its camera, pmj02bn, 512x512,
     64 spp, 1024^2 material of 0.5) under make_test_envmap(256, 512) by the
     dense route (path_loop_env, path_loop_grad_env), then the JAX package's
     own path + env scene (tools/bench_round3.py:39-44's env_scene: a uv
     sphere of 0.6 at 16 x 32 under make_test_envmap(128, 256), its camera)
     at the same 512x512, 64 spp, pmj02bn, 1024^2 material by accel="auto"
     (the BVH: path_loop_env_bvh, path_loop_grad_env_bvh); each drive holds
     its two kernels against their plain versions on its own inputs at every
     64th lane (the dense route over all the samples, the BVH over the first
     CHECK_SAMPLES), the forward bit for bit, the gradient at phase 7's
     bars; then the cornell box under the same envmap forced through the
     BVH at 128x128, 16 spp: its image equal bit for bit to the dense
     route's, its gradient at phase 7's bars against the dense route's;
 20. the samplers on the render paths: corrmj at 16 spp (the loop-free
     form) and at 12 (the generic instantiation), and pmj02bn at 12, each
     through every kernel family (path_loop and path_loop_grad, direct and
     direct_grad, collocated and collocated_grad, each by the dense route
     and through the BVH, and path_loop_env and path_loop_grad_env) on the
     cornell box at 128x128, the first 4 samples of every 64th lane, the
     forward bit for bit the plain version (both routes against one), the
     gradient at phase 7's bars; the rejection rounds of phase 3's probes
     at 96 and 65 spp; the kGen instantiations' ptxas; then the flagship
     with corrmj at 64 spp, pmj02bn at 96 and corrmj at 96 as phase 19
     drives its main paths (_slice_main: one launch of path_loop and of
     path_loop_grad, both against their plain versions at every 64th lane
     over all the samples, the forward bit for bit, the gradient at phase
     7's bars), its iteration (median of 3), each kernel alone, the
     counted-work bound (the draws and this run's rejection rounds, on
     the checked lanes, by the plain walk that the forward's check runs),
     a time a sample beside the pmj02bn 64-spp
     flagship's; under "samplers" and "sampler_checks" in path_loop's and
     path_loop_grad's records;
 21. the JAX package's unfused estimators, plain torch around the
     trace_closest and trace_any kernels: bench.py's flagship (cornell box +
     light @ 15, its camera, pmj02bn, 512x512, a 1024^2 material of 0.5) with
     scene.fused = False through Scene.render + loss.backward() at
     UNFUSED_SPP (the walk is bound by the host's launches: PERF.md), its
     launches (the two trace kernels only, no plain trace), its image
     against the loop route's at the same seed and spp at the golden bar on
     all but LOOP_VALUE_SHARE of its values, its gradient's channel sums at
     rtol 1e-5 and all but LOOP_TEXEL_SHARE of its texels at phase 7's rtol
     1e-4 (float-level flips of a few samples: LOOP_VALUE_SHARE's comment),
     the trace kernels on one of its
     own calls bit for bit against their plain versions and timed, its
     iteration (median of 3) and forward, each trace kernel's device time a
     launch (torch.profiler on a forward); the same flagship under nearest
     filtering; the direct integrator without MIS on the cornell box and on
     the protocol's 962 triangles by accel="auto" (the BVH); then at
     128x128, 16 spp each of those walks and the collocated golden sphere
     under nearest with the trace kernels against the same walk with the
     plain traces: the image bit for bit, the gradient at phase 7's bars;
 22. the texture-recovery apps (zdr_tpu_torch/apps/) through their
     main(argv), at their full sizes: the example (512x512, a 512^2
     material, GT 512 spp, 64 spp a step; APP_EXAMPLE_ITERS of its 500
     steps), its launches (direct_env_bvh and direct_grad_env_bvh, and
     trace_closest a sample of render_duvdxy), no other kernel and no plain
     version, the loss falling, the five EXRs read back by load_exr; the
     lightstage (30 lights, 512x512, 256 spp, 8 patterns, one step a
     pattern of its 200), its direct_bvh and direct_grad_bvh launches;
     fd_validate's whole protocol on the cornell box (96x96, 48^2, spp 1 ..
     256, 5 seeds; path_loop, path_loop_grad), its rows; the step times
     from the apps' RunLogger records; then one lightstage pattern's two
     kernels against their plain versions at every 64th lane (the first
     CHECK_SAMPLES samples, the forward bit for bit), render_duvdxy's
     trace_closest bit for bit against trace_closest_plain on its own rays
     at every 64th ray of every sample, timed (with the card's busy time by
     torch.profiler), and a checkpoint of the example's recovery after
     APP_CHECKPOINT_STEP steps loaded into a fresh Adam on the card, bit for
     bit, the next step from each bit-equal; an Adam step's time;
 23. multi-device rendering (zdr_tpu_torch/parallel.py) through
     parallel.launch: the flagship (512x512, 64 spp, 1024^2 material of
     0.5) by render_sharded + loss.backward() on PAR_RANKS gloo ranks on the
     one card, then on NCCL with one rank a card: one path_loop and one
     path_loop_grad launch a rank on its lanes, the image bit for bit the
     single-device Scene.render's, the gradient at phase 7's bars, the
     iteration's time a rank; render_batch of the lightstage's 8
     epsilon-off patterns (30 lights) at 128x128, 8 spp on the gloo ranks,
     every view bit for bit the sequential update_lights + Scene.render;
     dryrun_multichip's two losses; the lightstage's main(["--batched",
     ...]) at full size on one rank, PAR_LS_ITERS steps, their launches and
     step times; and at --small with tests/test_apps.py's batched recovery
     gate.
 24. the splat knobs (splat_merge, packed_splat; ROADMAP A17): the
     flagship at JAX's defaults (4, True) through Scene.render +
     loss.backward(), one launch each of path_loop, path_loop_grad (its
     kMerge instantiation) and splat_round; the flagship iteration at (1,
     False), (4, False), (1, True) and (4, True) in turns A B B A,
     SPLAT_ROUNDS each, medians; path_loop_grad at (4, False) and (4, True)
     against the plain backward at every 64th lane (one plain walk: the
     packed gradient is its totals rounded; _assert_splat_close: the
     touched texels equal, sums rtol 1e-5, texels at phase 7's bars or, packed,
     within one bf16 ulp, rounding flips counted; a merge may choose the
     other tap at FLIP_SHARE of the texels), each instantiation alone;
     splat_round bit for bit round_bf16, timed beside its plain version and
     x.to(torch.bfloat16).float(); direct_grad packed on the cornell box (16
     launches of its kPacked instantiation, one a group of 4 samples) and,
     on the big mesh, path_loop_grad_bvh at (4, True) and
     collocated_grad_bvh packed, each driven once through the Scene (its
     launches) and held against its plain version (the BVH kernels at the
     first CHECK_SAMPLES samples of every 64th lane), timed; the new
     instantiations' ptxas (registers, stack, spills).

 25. the direct kernels' emitter-first bounce lookup (the JAX package's
     merged bounce_emit mode and streamed emitter-first route: a closest
     hit over the light triangles, then one any-hit capped at 0.9999 of
     it), which every direct drive above took (at most 32 light
     triangles): on the protocol by the dense route and by accel="auto",
     the big mesh, the cornell box, apps/example.py's env scene (no light
     triangle: the any-hit to 1e30 tells an escape) and the lightstage's
     first pattern (14 light triangles), at their main paths' sizes: the
     emitter-first kernels against their plain versions (_bvh_check, phase
     10's bars); each scene's tables again with the cap lowered
     (scene_tables.MERGED_MAX_LIGHT_TRIS = -1: the closest lookup), both
     lookups' kernels alone and the iteration through the Scene in turns A
     B B A (medians of BOUNCE_REPS), emitter first against the closest
     lookup at full size (the image's mean and worst difference, the
     mean within BOUNCE_MEAN_BAR, the pixels past the golden bar; the
     gradient's error), the tests and visits a sample and the bounds of
     both lookups' counted work; ptxas of every direct instantiation; the
     main-path iterations of phases 11, 13, 18 and 22 beside them.
 26. the direct env BVH kernels as redesigned (the NEE shadow walk only
     where the light sample lies above the shading hemisphere; in tap mode
     the env sample's pdf and texels read after it, where NEE counts): the
     big mesh under make_test_envmap(256, 512) through Scene.render +
     loss.backward() by accel="auto" (_slice_main: the kernels against
     their plain versions at the first BOUNCE_CHECK_SAMPLES samples of
     every 64th lane, each alone, its counted work and bound); on it and on
     phase 18's example the shadow walks walked and skipped a sample, the
     env samples the tap mode reads after the walk (the plain walk on a
     stride of the lanes, _direct_env_work); ptxas of the direct env
     kernels beside their no-env twins; phase 22's example step.
 27. the path env kernels as redesigned (the NEE shadow walk only where
     the light sample lies above the shading hemisphere, in all four; the
     BVH env gradient at 8 blocks of 128 an SM): the big mesh
     under make_test_envmap(256, 512) through
     Scene.render + loss.backward() by accel="auto" (_slice_main: the BVH
     kernels against their plain versions at the first BOUNCE_CHECK_SAMPLES
     samples of every 64th lane, each alone, its counted work and bound);
     on it and on phase 19's two scenes the shadow walks walked and skipped
     a sample, the light samples below the hemisphere by kind, the tap
     mode's rows, replays and atomics (_TapWork), the counted work and the
     bounds with the taps counted; on env_scene and the big mesh at every
     CHECK_STRIDE-th lane the BVH forward's and the tap mode's tests and
     node visits equal to the plain walk's (_path_walk_counts); ptxas of
     the four path env kernels beside their no-env twins.

Phase 1 prints nvidia-smi's name and power limit on a line of their own;
a line before the last gives each phase's seconds.
The next-to-last line is the kernels' JSON record: "launches" on the main
path (every count is set to 0 just before each main-path call and read
just after: phase 6 for path_loop, 8 for path_loop_grad, 11's protocol by
the dense route for direct and direct_grad and by accel="auto" for
direct_bvh and direct_grad_bvh, whose big-mesh numbers of phase 13 stand
under "big_mesh", 13 for the path BVH kernels, 17's big mesh for
collocated_bvh and collocated_grad_bvh (the golden sphere's under
"golden_sphere") and its golden sphere by the dense route for collocated
and collocated_grad, 18's example by each route for the direct env kernels,
19's flagship under the envmap for path_loop_env and path_loop_grad_env
and its env_scene for path_loop_env_bvh and path_loop_grad_env_bvh, 21's
unfused flagship for trace_closest and trace_any (their "ms" the device
time a launch over its walk by torch.profiler, "plain_ms" and bounds on one
of its own bounce calls, phase 12's big mesh under "big_mesh"); phase 22's
apps under "apps" in the records of the kernels they launch (launches and
the median step; render_duvdxy's numbers in trace_closest's); phase 23's
under "parallel" in the records of path_loop, path_loop_grad, direct_bvh
and direct_grad_bvh (launches a rank a call, counted in the ranks);
phase 24's under "splat" in the records of path_loop_grad,
path_loop_grad_bvh, direct_grad and collocated_grad_bvh, and splat_round's
own record (its launches on phase 24's flagship at (4, True)); phase 25's
under "bounce_emit" in the records of the kernels each of its scenes ran,
by scene (its ptxas and the main paths' iterations in direct's); phase
26's big mesh under "big_mesh_env" in the records of direct_env_bvh and
direct_grad_env_bvh, phase 27's in those of path_loop_env_bvh and
path_loop_grad_env_bvh; for
the probes and the sweep variants, the sum over all of them; trace_interact's "body_launches" counts, by kernel, the launches of
phases 17-18's main paths, each of which runs B3's body a sample),
"max_abs_err" the largest difference from the plain version over the
kernel's checks, "ms" the kernel alone at the main path's shapes by CUDA
events, "plain_ms" its plain version by the host clock (on the inputs of
"plain_shape", a subset of the main path's where the full width would take
minutes), and
"bound_ms" the larger of the kernel's FP32 work (ray-triangle tests, 46
operations each or 40 for a Woop test, BVH node visits, VISIT_OPS each, and
tile-box tests, SLAB_OPS each, counted in this run)
at 67 TFLOP/s and its bytes (each input read once, each output written
once) at 3.35 TB/s; for path_loop, direct and direct_grad the bound of all
their counted work (_loop_bound, _direct_bound: FP32, INT32, the issue of
both, bytes; the path env kernels' likewise, with the BVH kernels' own
tests and visits, and the path gradients' with their taps), with the tests-only bound beside it as "bound_tests_ms" (for
direct and direct_grad, a test of the sweep with the early out counted up to
the place it leaves, EARLY_OPS, "test_ops" a test on average, and the
cornell box's numbers under "cornell_box"). The
last line is {"ok": true,
"device": {...}}.
Imports nothing of JAX.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RES, SPP, TEX = (512, 512), 64, 1024
PROTOCOL_SPP = 256
# the direct kernels are held against their plain versions at every
# CHECK_STRIDE-th lane of the main path
CHECK_STRIDE = 64
KERNELS = ("sampler_probe", "path_loop", "path_loop_grad", "trace_interact", "direct",
           "direct_grad", "trace_closest", "trace_any", "path_loop_bvh", "path_loop_grad_bvh",
           "direct_bvh", "direct_grad_bvh", "sweep_variant", "woop_sweep", "aabb_sweep",
           "floor_probe", "collocated", "collocated_grad", "collocated_bvh",
           "collocated_grad_bvh", "direct_env", "direct_grad_env", "direct_env_bvh",
           "direct_grad_env_bvh", "path_loop_env", "path_loop_grad_env", "path_loop_env_bvh",
           "path_loop_grad_env_bvh", "splat_round")
# the dense instantiations of the four megakernels
DENSE = ("path_loop", "path_loop_grad", "direct", "direct_grad")
# phases 11 and 13 hold the BVH kernels against their plain walks on the
# first CHECK_SAMPLES samples of every CHECK_STRIDE-th lane: the plain walk
# steps all its rays a node at a time, ~0.7 s a sample on the big mesh
CHECK_SAMPLES = 8
# the launch counts of every main-path call (_drive_main)
MAIN_COUNTS = []
# the H100 SXM's peaks (NVIDIA's data sheet, at 700 W): FP32 outside the
# tensor cores, HBM3
FP32_PEAK, HBM_RATE = 67e12, 3.35e12
# FP32 operations of one Moller-Trumbore ray-triangle test (mt_hit in
# kernels/csrc/path_loop_step.cuh): 2 cross products, 4 dot products, 3
# scalings, a reciprocal, a difference and u + v
MT_OPS = 46
# FP32 operations of a test of the compact sweep's early out (mt_early in
# kernels/csrc/direct_step.cuh), counted as MT_OPS is, up to each place a
# test may leave: u's numerator (a cross product, 2 dot products, the
# difference) and its two bounds; then v's and t's numerators (a cross
# product, 2 dot products) and their four bounds; then the division's
# reciprocal, 3 scalings and u + v
EARLY_OPS = (24, 24 + 23, 24 + 23 + 5)
# FP32 operations of one node visit's slab test (aabb_hit in
# kernels/csrc/trace.cuh; the reciprocal direction is computed once a ray):
# 6 differences and 6 products, 3 min and 3 max, 2 max and 2 min across the
# axes, 2 products by the slack, 3 comparisons
SLAB_OPS = 27
# FP32 operations of one node visit of the ordered walk (trace.cuh
# bvh_walk): both children's slab tests and the comparison of their entry
# distances
VISIT_OPS = 2 * SLAB_OPS + 1
# The path-loop step's work, counted from kernels/csrc/path_loop_step.cuh as
# compiled (-fmad=false: every multiply and add an operation of its own; a
# sqrt, division, sin or cos counted as one, the least it takes), for the
# bound of path_loop (_loop_bound). Integer operations of the pmj02bn draws,
# each 32-bit add, multiply, logic op, shift, rotate, compare, select or
# conversion one: next1 = xxhash32_z 12 + permute_pow2 36 + the blue-noise
# index 3 + a conversion + the dimension's increment; next2 = 107 where it
# permutes (instance >= 5: its shift and compare 2, xxhash32_z 12,
# permute_pow2 36, the mask 1, instance % 5 3, the seeds' selects 12, two
# owen_rev of 10 (an add, 4 multiply-xors, a bit reversal), sobol2_vdc 12,
# two blue-noise indices 6, two conversions, the increment) and 59 where it
# does not (the first three of a sample: the camera's and its first step's
# two).
NEXT1_INT, NEXT2_INT, NEXT2_SET_INT = 53, 107, 59
# corrmj's draws (the kGen instantiations' cmj_next1 / cmj_next2), counted
# as NEXT1_INT is: next1 = the key 3 + permute_pow2 36 + lcg_step 2 +
# lcg_to_unit_float 10 + a conversion + the dimension's increment; next2 =
# three keys 9, three permute_pow2 108, the stratum's row and column 2, two
# lcg_step 4 and lcg_to_unit_float 20, four conversions, the increment. A
# round of the generic permutation's rejection loop past the first
# (permute_round 34 and its test) adds PERM_ROUND_INT; the rounds depend on
# the data and are counted by the plain permutation (_PermRounds).
CMJ_NEXT1_INT, CMJ_NEXT2_INT, PERM_ROUND_INT = 53, 148, 35
# FP32 operations of a step besides the sweeps (MT_OPS a test) and the
# BSDF sample's branch: the bilinear fetch 49, the frame 32, two
# projections 30, two ggx_sample_pdf 110, the MIS weights 6, to_world 15,
# the bounce's test 7, the next origin 6, two ggx_brdf 150, roulette and
# throughput 21, NEE and the radiance 21, the hit's interaction 67, the NEE
# sample 50, the draws' float work 48; the BSDF sample: glossy (VNDF and
# reflect) 104 or diffuse 10, as the lane's u_lobe says; a restart's
# camera ray and accumulation 55.
STEP_FP, GLOSSY_FP, DIFFUSE_FP, RESTART_FP = 612, 104, 10, 55
# A direct sample's work besides its sweeps, counted from
# kernels/csrc/direct_step.cuh as compiled, as STEP_FP is (_direct_bound):
# FP32: the camera ray and the clamped accumulation 64, the hit's
# interaction 67, the bilinear fetch 49, the NEE sample 50, the frame 32,
# two projections 30, two ggx_sample_pdf 110, the BSDF sample's diffuse
# branch 10 (the least of its two), to_world 15, the bounce's test 7, the
# next origin 6, the MIS weights 6, two ggx_brdf 150, NEE's term, beta and
# the radiance 21, the draws' float work 48 (the bounce's interaction,
# which only a bouncing lane runs, is left out); the tap mode adds the taps'
# cotangents 24, their channels 25, two ggx_spec_droughness 80 and the
# splat corner 20. INT32: a sample's draws, three next1 and three next2
# that do not permute (the first nine dimensions), and the tap mode's salt
# (xxhash32_4, 20).
DIRECT_FP, DIRECT_TAP_FP = 665, 149
DIRECT_INT, DIRECT_TAP_INT = 3 * NEXT1_INT + 3 * NEXT2_SET_INT, 20
# FP32 operations of the env's light sample in nee_select<true>
# (kernels/csrc/path_loop_step.cuh, counted as DIRECT_FP is): two alias draws
# 24, the sample's uv 4, its pdf 8, env_uv_to_direction 9 and the bilinear
# fetch env_fetch 40, run where the light selection takes the env; and of a
# miss's env_miss_add: env_direction_to_uv 9, the pdf's bins, sine and
# scale 10, the selection's 1/n 1, the MIS weight 3, env_fetch 40 and the
# weighted radiance 3, run for each ray that misses (_EnvWork counts both)
ENV_NEE_FP, ENV_MISS_FP = 85, 66
# of ENV_NEE_FP, what the direct kernels' tap mode reads after the shadow
# walk and only where NEE counts (direct_step.cuh direct_sample<kGrad,
# kEnv>): the pdf 8 and env_fetch 40
ENV_READ_FP = 48
# A collocated sample's work besides its sweep (collocated_step.cuh, counted
# as DIRECT_FP is): FP32: the camera ray and the clamped accumulation 64, the
# hit's interaction 67, the bilinear fetch 49, the frame 32, a projection 15,
# ggx_brdf 75, 1/t^2 and the radiance 7; the tap mode adds the cotangents 3,
# the channels 12, ggx_spec_droughness 40 and the splat corner 20. INT32: the
# camera's next2 (no permutation) and the tap mode's salt.
COLLOCATED_FP, COLLOCATED_TAP_FP = 309, 75
COLLOCATED_INT, COLLOCATED_TAP_INT = NEXT2_SET_INT, 20
# What the path gradient kernels' tap mode adds to the walk
# (path_loop_step.cuh loop_step<kGrad = true>, replay_sample), counted as
# STEP_FP is, for their bound (_loop_bound with _TapWork's counts). A row,
# written by every step of a lane in flight: FP32: the NEE cotangents 9, two
# roughness taps (ggx_spec_cotangent 5 and ggx_spec_droughness 130 each,
# torch.func's reverse chain: ggx_alpha_vjp's half vector 13, D, F and G
# forward 48, their reverse 66), u0 and u3 2, the bounce adjoints 9, P's
# channels 6, the splat corner 22; INT32: the salt and its unit draw (28),
# where the row has a texel; 13 stores. A row replayed (the rows of a
# sample whose radiance is not NaN): FP32: the four channels 18, their
# NaN and zero tests 16, G' 3; 13 loads; and a 16-byte atomic where the
# tap adds something. The stores, loads and atomics count as issued
# instructions; their bytes (TAP_ROW_BYTES a row each way, in shared
# memory below the launch's k_near rows and in global scratch past them;
# 16 an atomic, in L2) are reported beside the bound, not in it: none of
# them need reach device memory.
PATH_TAP_FP, PATH_TAP_INT, PATH_REPLAY_FP = 318, 28, 37
TAP_ROW_PLANES = 13
TAP_ROW_BYTES = 4 * TAP_ROW_PLANES
# rates without FMA: one FP32 operation a lane a cycle (half the FMA peak),
# INT32 at half that (64 INT32 lanes an SM against 128 FP32: the Hopper
# white paper), and one warp instruction a cycle per SM quarter for both
# (128 operations an SM a cycle: the issue slots)
FP32_RATE, INT32_RATE, ISSUE_RATE = FP32_PEAK / 2, FP32_PEAK / 4, FP32_PEAK / 2


def _drive_main(fn):
    """One main-path call: every kernel's launch count set to 0 just before
    it and read just after -> (its result, the counts)."""
    from zdr_tpu_torch import kernels

    for k in KERNELS:
        getattr(kernels, k).launches = 0
    out = fn()
    counts = {k: getattr(kernels, k).launches for k in KERNELS}
    MAIN_COUNTS.append(counts)
    return out, counts


def _bound(tests, nbytes, visits=0, ops=MT_OPS, visit_ops=VISIT_OPS, extra_ops=0):
    """-> (bound_ms, bound_by): the larger of the tests' (`ops` each) and
    node visits' (`visit_ops` each; SLAB_OPS for the sweep variants' tile-box
    tests) FP32 operations, with extra_ops (the env's, _env_ops), at the FP32
    peak and the bytes at the memory rate."""
    t_ops = (tests * ops + visits * visit_ops + extra_ops) / FP32_PEAK * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _trace_nbytes(kname, acc, o, d, *t_range):
    """The bytes a trace function must move: its rays, the accel's rows and
    nodes, a t bound only where the call passes one a ray (a scalar bound
    is an argument, whatever the wrapper broadcasts), and its outputs: t,
    prim, u, v for the closest hit, one bool a ray for any hit."""
    n = o.shape[0]
    per_ray = [t for t in t_range if torch.is_tensor(t) and t.numel() == n]
    outs = 16 * n if kname.endswith("closest") else n
    return _nbytes(o, d, acc.geom, acc.nodes, *per_ray) + outs


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _flagship(device, integrator="path", accel="bruteforce"):
    """bench.py's cornell box + light and camera; the dense route unless
    `accel` says otherwise (phases 6, 8 and 11 hold the dense kernels)."""
    from zdr_tpu_torch.parallel import flagship_spec

    return flagship_spec(integrator, accel).build(device)


def _protocol(device, accel="bruteforce", integrator="direct", stacks=(16, 32)):
    """tools/bench_reference.py's scene: a uv sphere of 16 x 32 (960
    triangles) over a 2-triangle quad light of 40, its camera; direct; the
    dense route unless `accel` says otherwise. Phase 15 varies the sphere's
    stacks and the integrator."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_quad, make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5, *stacks), None, None),
                      (make_quad(size=1.0, y=-2.0), None, 40.0)],
                     integrator=integrator, accel=accel, device=device)
    scene.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    return scene


class _EnvWork:
    """Counts the env's work in a plain walk of module `mod` (path_loop or
    direct): while entered, mod.env_miss_add adds the rays it is given that
    miss to .miss (the kernels run env_miss_add for each of them), and
    mod.nee_select adds the light samples that take the env (their shadow ray
    runs to 1e30) to .nee, over the lanes of .live where that is set."""

    def __init__(self, mod):
        self.mod, self.miss, self.nee, self.live = mod, 0, 0, None

    def __enter__(self):
        miss_add, select = self.mod.env_miss_add, self.mod.nee_select

        def counted_miss_add(env, d, pdf_prev, miss, inv_n):
            self.miss += int(miss.sum())
            return miss_add(env, d, pdf_prev, miss, inv_n)

        def counted_select(tb, p, smp):
            out = select(tb, p, smp)
            env = out[0][1] == 1e30
            self.nee += int((env if self.live is None else env & self.live).sum())
            return out

        self.saved = (miss_add, select)
        self.mod.env_miss_add, self.mod.nee_select = counted_miss_add, counted_select
        return self

    def __exit__(self, *exc):
        self.mod.env_miss_add, self.mod.nee_select = self.saved


def _env_ops(work, grad=False):
    """FP32 operations of the env's counted work (_path_work's or
    _direct_env_work's env_miss and env_nee; in the direct kernels' tap mode
    (`grad` and env_read counted) the env samples whose pdf and texels it
    does not read without ENV_READ_FP)."""
    unread = work["env_nee"] - work["env_read"] if grad and "env_read" in work else 0
    return (work.get("env_miss", 0) * ENV_MISS_FP + work.get("env_nee", 0) * ENV_NEE_FP
            - unread * ENV_READ_FP)


class _ShadeWork:
    """Counts, in the plain direct forward while entered, the shadow rays
    that the direct kernels' shade walks (direct_step.cuh direct_sample):
    those of the shading lanes, under an env (`env`) only where the light
    sample lies above the hemisphere (wll.z >= 1e-4). .walks is the current
    shade's mask of them, set before its occlusion test runs; .walked and
    .skipped the shading lanes walked and not, and .read the env samples
    whose pdf and texels the tap mode reads after the walk (NEE counts:
    shading, clear and above). It wraps direct.shade_plain and bounce.occluded_plain, whose
    occlusion of every lane it reads."""

    def __init__(self, env=True):
        self.env, self.walks = env, None
        self.walked, self.skipped, self.read = 0, 0, 0

    def __enter__(self):
        from zdr_tpu_torch.integrators import bounce
        from zdr_tpu_torch.integrators import direct as dr
        from zdr_tpu_torch.microfacet import make_onb, to_local

        self.saved = (dr.shade_plain, bounce.occluded_plain)
        shade, occluded = self.saved
        seen = []

        def counted_occluded(*args, **kw):
            occ = occluded(*args, **kw)
            seen[:] = [occ]
            return occ

        def counted_shade(scene, ray, nee, *args, **kw):
            on = ray[12] != 0
            self.walks = on
            if self.env:
                t, b = make_onb(ray[3:6])
                self.walks = on & (to_local(t, b, ray[3:6], nee[0:3])[2] >= 1e-4)
            out = shade(scene, ray, nee, *args, **kw)
            self.walked += int(self.walks.sum())
            self.skipped += int((on & ~self.walks).sum())
            self.read += int((self.walks & ~seen[0] & (nee[3] == 1e30)).sum())
            return out

        dr.shade_plain, bounce.occluded_plain = counted_shade, counted_occluded
        return self

    def __exit__(self, *exc):
        from zdr_tpu_torch.integrators import bounce
        from zdr_tpu_torch.integrators import direct as dr

        dr.shade_plain, bounce.occluded_plain = self.saved


def _path_work(tb, lanes, mat, stride=16, carry_out=None):
    """The work of the path-loop kernels' walk, counted on every
    `stride`-th lane with the plain step and scaled to all lanes (the walk's
    final carry, which is the plain forward's on those lanes, appended to
    `carry_out` where a list is given) -> {kind:
    the sampler, rounds: the generic permutations' rounds past the first
    (those of the lanes that run, by their share of the plain walk's),
    tests:
    ray-triangle tests (each step a lane runs sweeps the whole table for its
    next hit, and a shading lane's shadow sweep stops at its first hit;
    under an env only where the kernels walk it, the light sample above the
    shading hemisphere: loop_step<kEnv>), steps: the lanes' steps,
    restarts: the samples begun, glossy: steps whose BSDF sample takes the
    glossy lobe; shadow_walked / shadow_skipped: the shading steps whose
    shadow ray the kernels walk and skip; below_env / below_mesh: the
    shading steps whose light sample (the env's, or a mesh or point
    light's) lies below the hemisphere, with or without an env; under an
    env, env_miss: the env lookups of rays that miss, env_nee: the light
    samples that take the env}. The tests are the dense sweep's: pass the tables without
    their BVH (the routes' walks are equal, so the rest counts the same);
    through a BVH (on a scene too large to sweep) they are not counted (0:
    the BVH kernels count their own)."""
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.microfacet import make_onb, to_local

    sub = lanes[:, ::stride].contiguous()
    carry = pl.init_carry(sub)
    n_tris = tb.scene.shape[0]
    fi, ii = pl.F_IDX, pl.I_IDX
    work = dict(tests=0, steps=0, restarts=0, glossy=0, env_miss=0, env_nee=0,
                shadow_walked=0, shadow_skipped=0, below_env=0, below_mesh=0)
    counter, perm = _EnvWork(pl), _PermRounds()
    walked = 0
    for _ in range(tb.n_steps):
        flying = carry.i[ii["in_flight"]] != 0
        run = (carry.i[ii["sample_idx"]] < sub[2]) | flying
        if not bool(run.any()):
            break
        shade = run & flying & (carry.i[ii["shade"]] != 0)
        ns = tuple(carry.f[fi[k]] for k in ("ns_x", "ns_y", "ns_z"))
        t_, b_ = make_onb(ns)
        wl_all = tuple(carry.f[fi[k]] for k in ("wl_x", "wl_y", "wl_z"))
        below = shade & (to_local(t_, b_, ns, wl_all)[2] < 1e-4)
        env_sample = carry.f[fi["l_dist"]] == 1e30
        walk = shade & ~below if tb.env is not None else shade
        work["shadow_walked"] += int(walk.sum())
        work["shadow_skipped"] += int((shade & ~walk).sum())
        work["below_env"] += int((below & env_sample).sum())
        work["below_mesh"] += int((below & ~env_sample).sum())
        if tb.bvh is None:
            p = tuple(carry.f[fi[k]][walk] for k in ("p_x", "p_y", "p_z"))
            wl = tuple(x[walk] for x in wl_all)
            ok, _u, _v, t = pl._mt_all(tb.scene, p, wl)
            hit = ok & (t > 1e-4) & (t < carry.f[fi["l_dist"]][walk][:, None])
            first = torch.where(hit.any(1), hit.int().argmax(1) + 1, n_tris)
            work["tests"] += int(run.sum()) * n_tris + int(first.sum())
        work["steps"] += int(run.sum())
        walked += sub.shape[1]
        work["glossy"] += int((run & (carry.f[fi["u_lobe"]] >= 0.5)).sum())
        before = carry.i[ii["sample_idx"]].clone()
        # a finished lane idles in the plain step; the kernel's stops
        counter.live = run
        with counter, perm:
            carry = pl.loop_step(carry, tb, sub, mat)
        # a lane restarts where it begins a sample: it ends in flight at a
        # sample below its stop that it was not in flight at before
        began = (carry.i[ii["in_flight"]] != 0) & ~(flying & (before == carry.i[ii["sample_idx"]]))
        work["restarts"] += int((run & began).sum())
    work["env_miss"], work["env_nee"] = counter.miss, counter.nee
    work["rounds"] = perm.rounds * work["steps"] / max(walked, 1)
    if carry_out is not None:
        carry_out.append(carry)
    scale = lanes.shape[1] / sub.shape[1]
    return dict({k: v * scale for k, v in work.items()}, kind=tb.kind)


class _PermRounds:
    """While on, counts the plain generic permutation's work: the
    samplers' permutation_element wrapped by one that keeps `draws` (the
    permutations made), `rounds` (the rounds past the first) and `most`
    (the most rounds past the first of one permutation), each from
    hashes.permutation_rounds."""

    def __init__(self):
        self.draws = self.rounds = self.most = 0

    def __enter__(self):
        from zdr_tpu_torch.samplers import corrmj, hashes, pmj02bn

        def counted(i, l, w, p):
            out, rounds = hashes.permutation_rounds(i, l, w, p)
            self.draws += rounds.numel()
            self.rounds += int(rounds.sum())
            self.most = max(self.most, int(rounds.max()) if rounds.numel() else 0)
            return out

        self.mods = (corrmj, pmj02bn)
        self.saved = [m.permutation_element for m in self.mods]
        for m in self.mods:
            m.permutation_element = counted
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.permutation_element = f


def _early_work(tb, lanes, mat, stride=4 * CHECK_STRIDE):
    """The early out's tests by the place they leave (accel/trace.py
    early_stages), counted on every `stride`-th lane over the rays that the
    plain direct samples sweep as the kernel does (each primary ray, a
    shading lane's shadow ray (under an env only where its light sample
    lies above the hemisphere, _ShadeWork: the plain version tests every
    shading lane, the count only what the kernel walks), and a bouncing
    lane's bounce ray: its closest hit, or emitter first its tests of the
    light triangles and its capped any-hit where it walks) -> ((4,) int64
    tests: left after u's
    numerator, after v's and t's, at the division, and the light
    triangles' whole tests; the lanes (3, N'))."""
    from zdr_tpu_torch.accel.trace import early_stages
    from zdr_tpu_torch.integrators import bounce
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators.path_loop import T_MAX

    sub = lanes[:, ::stride].contiguous()
    stages = torch.zeros(4, dtype=torch.int64, device=lanes.device)
    shading = _ShadeWork(env=tb.env is not None)

    def counted_trace(scene, rays, lite=False, bvh=None):
        act = rays[7] != 0
        o, d = tuple(x[act] for x in rays[0:3]), tuple(x[act] for x in rays[3:6])
        stages[:3] += early_stages(scene, o, d, torch.full_like(o[0], T_MAX))
        return trace(scene, rays, lite, bvh)

    def counted_occluded(scene, p, wi, dist, bvh=None):
        m = shading.walks
        stages[:3] += early_stages(scene, tuple(x[m] for x in p), tuple(x[m] for x in wi),
                                   dist[m], any_hit=True)
        return occluded(scene, p, wi, dist, bvh)

    def counted_light_hit(scene, lights, light_rows, o, d, pdf_prev, active):
        stages[3] += int(active.sum()) * lights.shape[0]
        return light_hit(scene, lights, light_rows, o, d, pdf_prev, active)

    def counted_bounce_any(scene, o, d, t_max, active, bvh=None):
        stages[:3] += early_stages(scene, tuple(x[active] for x in o),
                                   tuple(x[active] for x in d), t_max[active], any_hit=True,
                                   from_zero=True)
        return bounce_any(scene, o, d, t_max, active, bvh)

    with shading:
        trace, occluded = dr.trace_interact_plain, bounce.occluded_plain
        light_hit, bounce_any = dr.light_hit_plain, dr.bounce_any_plain
        dr.trace_interact_plain, bounce.occluded_plain = counted_trace, counted_occluded
        dr.light_hit_plain, dr.bounce_any_plain = counted_light_hit, counted_bounce_any
        try:
            dr.render_direct_plain(tb, sub, mat)
        finally:
            dr.trace_interact_plain, bounce.occluded_plain = trace, occluded
            dr.light_hit_plain, dr.bounce_any_plain = light_hit, bounce_any
    return stages.cpu(), sub


def _test_ops(stages=None):
    """FP32 operations of a dense direct kernel's test: MT_OPS, or for the
    sweep with the early out the mean of EARLY_OPS over the places that
    `stages` (_early_work's counts) says its tests leave, with the light
    triangles' tests at MT_OPS."""
    if stages is None:
        return MT_OPS
    ops = EARLY_OPS + (MT_OPS,)
    return sum(n * k for n, k in zip(stages.tolist(), ops)) / int(stages.sum())


# the lanes on which the direct env's work is counted: a stride that is no
# multiple of an image row's 512 lanes, so that the lanes walk across the
# columns (every 256th lane of a 512-wide image is two columns)
ENV_WORK_STRIDE = 4 * CHECK_STRIDE + 1


def _direct_env_work(tb, lanes, mat, stride=ENV_WORK_STRIDE):
    """The env's work of the direct kernels, counted with the plain direct
    samples on every `stride`-th lane and scaled to all lanes -> {env_miss:
    the primary and bounce rays that miss, env_nee: the light samples that
    take the env, env_read: those whose pdf and texels the kernels read
    (_ShadeWork), shadow_walked / shadow_skipped: the shading lanes' shadow
    rays walked and not}; {} without an env."""
    from zdr_tpu_torch.integrators import direct as dr

    if tb.env is None:
        return {}
    sub = lanes[:, ::stride].contiguous()
    with _EnvWork(dr) as counter, _ShadeWork() as shading:
        dr.render_direct_plain(tb, sub, mat)
    scale = lanes.shape[1] / sub.shape[1]
    return dict(env_miss=counter.miss * scale, env_nee=counter.nee * scale,
                env_read=shading.read * scale, shadow_walked=shading.walked * scale,
                shadow_skipped=shading.skipped * scale)


def _direct_bound(tests, samples, nbytes, grad=False, test_ops=MT_OPS, env_work=None):
    """The least time of a dense direct launch's counted work -> (bound_ms,
    bound_by, {term: ms}): the larger of its FP32 operations (the kernel's
    counted tests, `test_ops` each (_test_ops), and DIRECT_FP a sample,
    with the taps' DIRECT_TAP_FP in tap mode, and the env's work,
    env_work's misses and env samples (_direct_env_work, _env_ops)) at
    FP32_RATE, the draws' integer operations at INT32_RATE, both together at
    ISSUE_RATE, and the bytes at HBM_RATE."""
    fp = (tests * test_ops + samples * (DIRECT_FP + (DIRECT_TAP_FP if grad else 0))
          + _env_ops(env_work or {}, grad))
    ints = samples * (DIRECT_INT + (DIRECT_TAP_INT if grad else 0))
    terms = {"fp32": fp / FP32_RATE * 1e3, "int32": ints / INT32_RATE * 1e3,
             "issue": (fp + ints) / ISSUE_RATE * 1e3, "bytes": nbytes / HBM_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def _collocated_bound(tests, samples, nbytes, grad=False):
    """The least time of a dense collocated launch's counted work, as
    _direct_bound's: its tests at MT_OPS, COLLOCATED_FP a sample (and the
    taps' COLLOCATED_TAP_FP), the camera's integer draws."""
    fp = tests * MT_OPS + samples * (COLLOCATED_FP + (COLLOCATED_TAP_FP if grad else 0))
    ints = samples * (COLLOCATED_INT + (COLLOCATED_TAP_INT if grad else 0))
    terms = {"fp32": fp / FP32_RATE * 1e3, "int32": ints / INT32_RATE * 1e3,
             "issue": (fp + ints) / ISSUE_RATE * 1e3, "bytes": nbytes / HBM_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def _loop_bound(work, nbytes, taps=None):
    """The least time of a path-loop launch's counted work -> (bound_ms,
    bound_by, {term: ms}): the larger of the FP32 operations (the sweeps'
    tests, node visits on the BVH route (work's "visits"), and the steps',
    STEP_FP and the rest) at FP32_RATE, the draws' integer operations at
    INT32_RATE, both together at ISSUE_RATE, and the bytes at HBM_RATE;
    under an env, its misses' and light samples' work (_env_ops) among the
    FP32 operations. With `taps` (_TapWork's counts, scaled to the launch)
    the gradient kernel's: its rows' and replay's operations
    (PATH_TAP_FP ...), and their stores, loads and atomics among the issued
    instructions."""
    steps, restarts, glossy = work["steps"], work["restarts"], work["glossy"]
    fp = (work["tests"] * MT_OPS + work.get("visits", 0) * VISIT_OPS + steps * STEP_FP
          + glossy * GLOSSY_FP + (steps - glossy) * DIFFUSE_FP + restarts * RESTART_FP
          + _env_ops(work))
    if work.get("kind") == "corrmj":
        ints = steps * 4 * CMJ_NEXT1_INT + (steps * 2 + restarts) * CMJ_NEXT2_INT
    else:
        ints = (steps * 4 * NEXT1_INT + (steps - restarts) * 2 * NEXT2_INT
                + restarts * 3 * NEXT2_SET_INT)
    ints += work.get("rounds", 0) * PERM_ROUND_INT
    mem = 0
    if taps is not None:
        fp += taps["rows"] * PATH_TAP_FP + taps["replayed"] * PATH_REPLAY_FP
        ints += taps["ids"] * PATH_TAP_INT
        mem = (taps["rows"] + taps["replayed"]) * TAP_ROW_PLANES + taps["atomics"]
    terms = {"fp32": fp / FP32_RATE * 1e3, "int32": ints / INT32_RATE * 1e3,
             "issue": (fp + ints + mem) / ISSUE_RATE * 1e3, "bytes": nbytes / HBM_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


class _TapWork:
    """Counts, in the plain path backward (render_path_backward_loop_plain)
    while entered, the tap mode's work as the gradient kernels do it: .rows
    the rows written (a step of a lane in flight; .by_depth by the row's
    depth), .ids the rows with a texel, .replayed the rows replayed (a
    sample's depth + 1 rows where it ends with a radiance that is not NaN)
    and .atomics the taps that add something (a texel, a channel not 0 after
    the post-pass: splat_add4's test). It wraps path_loop.loop_step and
    scatter_add4."""

    def __init__(self):
        self.rows = self.ids = self.replayed = self.atomics = 0
        self.by_depth = {}

    def __enter__(self):
        from zdr_tpu_torch.integrators import path_loop as pl

        self.saved = (pl.loop_step, pl.scatter_add4)
        step, scatter = self.saved

        def counted_step(carry, tb, lanes, material, le_grad=None):
            out = step(carry, tb, lanes, material, le_grad)
            if le_grad is None:
                return out
            taps = out[1]
            flags, ids = taps[15], taps[14]
            row = (flags & 4) != 0
            depth = carry.i[pl.I_IDX["depth"]]
            self.rows += int(row.sum())
            for d, n in zip(*torch.unique(depth[row], return_counts=True)):
                self.by_depth[int(d)] = self.by_depth.get(int(d), 0) + int(n)
            self.ids += int((row & (ids < material.shape[0] * material.shape[1])).sum())
            ended = (flags & 3) == 3
            self.replayed += int((depth[ended] + 1).sum())
            return out

        def counted_scatter(ids, vals, n_bins, packed=False):
            self.atomics += int(((ids < n_bins) & (vals != 0).any(1)).sum())
            return scatter(ids, vals, n_bins, packed=packed)

        # loop_step counts its calls on the module's loop_step
        counted_step.calls = step.calls
        pl.loop_step, pl.scatter_add4 = counted_step, counted_scatter
        return self

    def __exit__(self, *exc):
        from zdr_tpu_torch.integrators import path_loop as pl

        self.saved[0].calls = pl.loop_step.calls
        pl.loop_step, pl.scatter_add4 = self.saved

    def scaled(self, scale, k_near):
        """The counts times `scale`, with the rows' bytes each way by where
        they lie (k_near rows a sample in shared memory, the deeper ones in
        global scratch) and the atomics' bytes."""
        far = sum(n for d, n in self.by_depth.items() if d >= k_near)
        out = {k: getattr(self, k) * scale for k in ("rows", "ids", "replayed", "atomics")}
        out.update(row_bytes_shared=(self.rows - far) * scale * TAP_ROW_BYTES,
                   row_bytes_global=far * scale * TAP_ROW_BYTES,
                   atomic_bytes=self.atomics * scale * 16)
        return out


def _material(seed, device, tex=TEX):
    """Random (tex, tex, 4) material: diffuse in [0.1, 0.9], roughness in
    [0.2, 0.9]."""
    g = torch.Generator().manual_seed(seed)
    mat = 0.1 + 0.8 * torch.rand((tex, tex, 4), generator=g)
    mat[..., 3] = 0.2 + 0.7 * torch.rand((tex, tex), generator=g)
    return mat.to(device)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)
    return name, smi


# the BVH megakernels by a piece of their mangled entry names
BVH_ENTRIES = {"direct_bvh": "direct_bvh_kernelILb0ELb0E",
               "direct_grad_bvh": "direct_bvh_kernelILb1ELb0E",
               "path_loop_bvh": "path_loop_bvh_kernelILb0E",
               "path_loop_grad_bvh": "path_loop_grad_bvh_kernelILb0E",
               "path_loop_env_bvh": "path_loop_bvh_kernelILb1E",
               "path_loop_grad_env_bvh": "path_loop_grad_bvh_kernelILb1E",
               "direct_env_bvh": "direct_bvh_kernelILb0ELb1E",
               "direct_grad_env_bvh": "direct_bvh_kernelILb1ELb1E",
               "collocated_bvh": "collocated_bvh_kernelILb0E",
               "collocated_grad_bvh": "collocated_bvh_kernelILb1E"}
# the dense direct kernels' instantiations (direct_kernel<kGrad, kEarly,
# kEnv>): the sweeps without and with the early out, without and with the
# envmap; the dense collocated kernels
DIRECT_ENTRIES = {"direct": "direct_kernelILb0ELb0ELb0E",
                  "direct_early": "direct_kernelILb0ELb1ELb0E",
                  "direct_grad": "direct_kernelILb1ELb0ELb0E",
                  "direct_grad_early": "direct_kernelILb1ELb1ELb0E",
                  "direct_env": "direct_kernelILb0ELb0ELb1E",
                  "direct_env_early": "direct_kernelILb0ELb1ELb1E",
                  "direct_grad_env": "direct_kernelILb1ELb0ELb1E",
                  "direct_grad_env_early": "direct_kernelILb1ELb1ELb1E",
                  "collocated": "collocated_kernelILb0E",
                  "collocated_grad": "collocated_kernelILb1E"}
# the dense path-loop kernels (path_loop_kernel<kEnv>,
# path_loop_grad_kernel<kEnv>), without and with the envmap
PATH_ENTRIES = {"path_loop": "path_loop_kernelILb0E",
                "path_loop_grad": "path_loop_grad_kernelILb0E",
                "path_loop_env": "path_loop_kernelILb1E",
                "path_loop_grad_env": "path_loop_grad_kernelILb1E"}
# each without (its name) and with the generic sampler (its name and
# "_gen"): the template's argument after those above, kGen; the gradient
# kernels take one more, the splat knob (kMerge of the path gradient
# kernels, kPacked of the direct and collocated ones), false in the
# instantiations above and true in SPLAT_ENTRIES' ("_merge" or "_packed",
# then "_gen")
_ENTRIES = {**BVH_ENTRIES, **DIRECT_ENTRIES, **PATH_ENTRIES}
_KNOB_KERNELS = ("path_loop_grad", "direct_kernel", "direct_bvh", "collocated")
SPLAT_ENTRIES = {f"{k}_{'merge' if k.startswith('path') else 'packed'}": v
                 for k, v in _ENTRIES.items() if "grad" in k}


def _knob(key):
    return "Lb0E" if key.startswith(_KNOB_KERNELS) else ""


PTXAS_ENTRIES = {**{k: f"{v}Lb0E{_knob(v)}" for k, v in _ENTRIES.items()},
                 **{f"{k}_gen": f"{v}Lb1E{_knob(v)}" for k, v in _ENTRIES.items()},
                 **{k: f"{v}Lb0ELb1E" for k, v in SPLAT_ENTRIES.items()},
                 **{f"{k}_gen": f"{v}Lb1ELb1E" for k, v in SPLAT_ENTRIES.items()}}


def ptxas_bvh(log):
    """ptxas -v's report -> {kernel of PTXAS_ENTRIES: {registers,
    local_bytes (its stack frame), spill_stores, spill_loads}}."""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and props:
            out.setdefault(props, {}).update(zip(("local_bytes", "spill_stores", "spill_loads"),
                                                 map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return {name: out[e] for name, key in PTXAS_ENTRIES.items() for e in out if key in e}


def phase_build():
    """Phase 2 -> the megakernels' ptxas report (ptxas_bvh)."""
    from zdr_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load_library()
    log = kernels.build_info["log"]
    regs = [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    report = ptxas_bvh(log)
    if sorted(report) != sorted(PTXAS_ENTRIES):
        raise AssertionError(f"ptxas reported {sorted(report)} of {sorted(PTXAS_ENTRIES)}")
    print(f"[2 build] nvcc sm_90a {time.perf_counter() - t0:.2f} s into "
          f"{os.path.relpath(kernels.BUILD_DIR, ROOT)}; the megakernels' registers, local "
          f"bytes (stack frame) and spill bytes: "
          f"{json.dumps(report)}; ptxas: {' | '.join(regs)}", flush=True)
    return report


def _event_ms(fn, reps=5):
    """Median of `reps` runs after a warm-up, each timed by CUDA events
    around it -> (ms, runs)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


# calls a CUDA graph holds, for a device time a call (_graph_ms), and the
# rounds of floor_probe and torch.add that phase 14 takes in turns
GRAPH_CALLS = 200
FLOOR_ROUNDS = 9


def _graph_ms(fn, reps=5):
    """fn's device time a call: GRAPH_CALLS calls captured in a CUDA graph
    (after a warm-up on a side stream), the graph replayed between one
    event pair, the median of `reps` replays / GRAPH_CALLS -> ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return statistics.median(times)


def _median_ms(fn, reps=5):
    """Median of `reps` synchronised runs after a warm-up, timed by the host
    clock -> (ms, runs)."""
    fn()
    times = [_sync_ms(fn)[1] for _ in range(reps)]
    return statistics.median(times), times


# phase 3's samplers, beside lcg and pmj02bn at SPP: corrmj in the loop-free
# form (64) and the generic one (96: a grid side of 9, row strata past the
# grid; 65: a power-of-two side under a spp that is none), pmj02bn's generic
# permutation at 96 and 65 (one past a power of two: the most rejections)
PROBES = (("lcg", SPP), ("pmj02bn", SPP), ("corrmj", SPP), ("corrmj", 96), ("corrmj", 65),
          ("pmj02bn", 96), ("pmj02bn", 65))


def _probe_ints(kind, k, n, rounds):
    """The integer operations of sampler_probe's k (next1, next2) pairs on
    n lanes (the fresh sampler aside), with `rounds` rejection rounds."""
    if kind == "lcg":
        return n * k * 3 * 12  # lcg_step 2 and lcg_to_unit_float 10 a draw
    if kind == "corrmj":
        return n * k * (CMJ_NEXT1_INT + CMJ_NEXT2_INT) + rounds * PERM_ROUND_INT
    # pmj02bn: the next2 of pair j (dimension 3j + 1) permutes from j = 3
    pairs = sum(NEXT1_INT + (NEXT2_INT if (3 * j + 1) // 2 >= 5 else NEXT2_SET_INT)
                for j in range(k))
    return n * pairs + rounds * PERM_ROUND_INT


def phase_sampler_probe(dev):
    """Phase 3: the kernel's sampler bit for bit against the plain sampler
    at each of PROBES, each timed, with its bound (the larger of its bytes
    and its integer operations, the rejection rounds counted by the plain
    permutation) and the rounds -> the record (pmj02bn at SPP's numbers,
    and every probe's under "by_sampler")."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.samplers import sampler_probe_plain
    from zdr_tpu_torch.samplers.pmj02bn import bluenoise

    g = torch.Generator().manual_seed(1)
    n, k = RES[0] * RES[1], 8
    pixels = torch.stack([
        torch.randint(0, 4096, (n,), generator=g), torch.randint(0, 4096, (n,), generator=g),
        torch.randint(-2**31, 2**31, (n,), generator=g)])
    unit = torch.rand((n,), generator=g)
    bn = bluenoise(dev)
    runs = {}
    for kind, spp in PROBES:
        lanes = torch.cat([pixels, (unit * spp).long().clamp_max(spp - 1)[None]]).to(
            torch.int32).to(dev)
        got = kernels.sampler_probe(kind, spp, lanes, k, bn)
        with _PermRounds() as perm:
            want = sampler_probe_plain(kind, spp, lanes, k, bn)
        draws, rounds, most = perm.draws, perm.rounds, perm.most
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"sampler_probe {kind} {spp} spp: {bad} of {got.numel()} "
                                 f"draws differ")
        ms = _event_ms(lambda: kernels.sampler_probe(kind, spp, lanes, k, bn))[0]
        plain_ms = _event_ms(lambda: sampler_probe_plain(kind, spp, lanes, k, bn))[0]
        t_bytes = _nbytes(lanes, bn[0]) + 3 * k * n * 4
        ints = _probe_ints(kind, k, n, rounds)
        terms = {"bytes": t_bytes / HBM_RATE * 1e3, "int32": ints / INT32_RATE * 1e3}
        by = max(terms, key=terms.get)
        runs[f"{kind}_{spp}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=terms[by],
            bound_by="bytes" if by == "bytes" else "operations", bound_terms_ms=terms,
            generic_permutations=draws, rounds=rounds,
            rounds_mean=rounds / draws if draws else 0.0, rounds_most=most)
    print(f"[3 sampler_probe] every sampler bit-exact against the plain one over {n} lanes x "
          f"{3 * k} draws; " + "; ".join(
              f"{kk} kernel {r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})" + (
                  f", {r['rounds_mean']:.3f} rejection rounds a generic permutation, "
                  f"most {r['rounds_most']}" if r["generic_permutations"] else "")
              for kk, r in runs.items()), flush=True)
    flag = runs[f"pmj02bn_{SPP}"]
    return dict(launches=None, max_abs_err=0.0, ms=flag["ms"], plain_ms=flag["plain_ms"],
                plain_shape=f"{n} lanes x {3 * k} draws", bound_ms=flag["bound_ms"],
                bound_by=flag["bound_by"], library_ms=None, by_sampler=runs)


def phase_step(dev):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _flagship(dev)
    mat = _material(2, dev)
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config((128, 128), 16), 0)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    carry = pl.init_carry(lanes)
    worst = 0.0
    for advance in (0, 5):
        for _ in range(advance):
            carry = pl.loop_step(carry, tb, lanes, mat)
        got = kernels.path_loop(tb, lanes, mat, carry, 1)
        want = pl.loop_step(carry, tb, lanes, mat)
        torch.cuda.synchronize()
        worst = max(worst, _assert_step(got, want, carry, lanes))
    print(f"[4 step] kernel n_steps=1 vs loop_step at 128x128 from step 0 and 5: ints equal, "
          f"max float diff {worst:.3e} (atol 1e-6, rtol 1e-6; l_pdf rtol 1e-4)", flush=True)


def _assert_step(got, want, before, lanes):
    """Ints equal; floats within atol=1e-6 and rtol=1e-6, but l_pdf =
    dist^2 / (area * cos), ill-conditioned at grazing light samples, within
    rtol=1e-4 and only where it is read (shading lanes whose light sample
    contributes). A lane already finished in `before` is skipped by the
    kernel and idles in the plain step: only its acc and sample_idx count."""
    from zdr_tpu_torch.integrators import path_loop as pl

    si = pl.I_IDX["sample_idx"]
    live = ~((before.i[si] >= lanes[2]) & (before.i[pl.I_IDX["in_flight"]] == 0))
    if not torch.equal(got.i[:, live], want.i[:, live]) or not torch.equal(got.i[si], want.i[si]):
        bad = (got.i != want.i) & live
        raise AssertionError(f"path_loop step: int rows differ in {int(bad.any(0).sum())} lanes")
    if not bool(torch.isclose(got.f[0:3], want.f[0:3], rtol=1e-6, atol=1e-6).all()):
        raise AssertionError("path_loop step: acc differs")
    rows = [k for k, n in enumerate(pl.F_NAMES) if n != "l_pdf"]
    gf, wf = got.f[rows][:, live], want.f[rows][:, live]
    both_nan = torch.isnan(gf) & torch.isnan(wf)
    close = torch.isclose(gf, wf, rtol=1e-6, atol=1e-6) | both_nan
    if not bool(close.all()):
        names = [pl.F_NAMES[rows[r]] for r in torch.nonzero(~close.all(1)).flatten().tolist()]
        raise AssertionError(f"path_loop step: float rows differ: {names}")
    lev = want.f[[pl.F_IDX[n] for n in ("lev_r", "lev_g", "lev_b")]]
    used = live & (want.i[pl.I_IDX["shade"]] != 0) & (lev != 0).any(0)
    k = pl.F_IDX["l_pdf"]
    if not bool(torch.isclose(got.f[k, used], want.f[k, used], rtol=1e-4, atol=0.0).all()):
        raise AssertionError("path_loop step: l_pdf differs where it is read")
    return float(torch.where(both_nan, 0.0, (gf - wf).abs()).max())


def phase_render(dev):
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _flagship(dev)
    mat = _material(3, dev)
    img = scene.render(mat, res=(128, 128), spp=16, seed=5)
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config((128, 128), 16), 5)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    plain = pl.render_path_loop_plain(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want = (plain.f[0:3] / torch.tensor(16.0, device=dev)).T.reshape(128, 128, 3)
    torch.cuda.synchronize()
    diff = (img[..., :3] - want).abs()
    mean = float(diff.mean())
    within = float((diff.amax(-1) <= 1e-5).float().mean())
    if not (mean <= 1e-6 and within >= 0.999):
        raise AssertionError(f"render 128x128: mean abs diff {mean:.3e}, {within:.4%} within 1e-5")
    print(f"[5 render] 128x128 16 spp kernel vs plain: mean abs diff {mean:.3e}, "
          f"{within:.4%} of pixels within 1e-5, max {float(diff.max()):.3e}", flush=True)


def phase_main(dev, smi):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _flagship(dev)
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev)
    plain_steps, plain_calls = pl.loop_step.calls, pl.render_path_loop_plain.calls
    (img, first_ms), counts = _drive_main(
        lambda: _sync_ms(lambda: scene.render(mat, res=RES, spp=SPP, seed=0)))
    launches = counts["path_loop"]
    if launches < 1:
        raise AssertionError("the main path did not launch the path_loop kernel")
    if (pl.loop_step.calls, pl.render_path_loop_plain.calls) != (plain_steps, plain_calls):
        raise AssertionError("the main path ran the plain version")
    if tuple(img.shape) != (RES[1], RES[0], 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"main path image: shape {tuple(img.shape)} or non-finite values")

    times = [_sync_ms(lambda: scene.render(mat, res=RES, spp=SPP, seed=0))[1] for _ in range(5)]
    ms = statistics.median(times)

    # the kernel alone and its plain version, on the render's own tables
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(RES, SPP), 0)
    lanes = pl.pixel_lanes(RES, SPP, dev)
    carry0 = pl.init_carry(lanes)
    kernel_ms, _runs = _event_ms(lambda: kernels.path_loop(tb, lanes, mat, carry0, tb.n_steps))
    plain, plain_ms = _sync_ms(lambda: pl.render_path_loop_plain(
        tb, lanes, mat, carry0, tb.n_steps))
    want = (plain.f[0:3] / torch.tensor(float(SPP), device=dev)).T.reshape(RES[1], RES[0], 3)
    means = img[..., :3].mean(dim=(0, 1))
    want_means = want.mean(dim=(0, 1))
    if not bool(torch.allclose(means, want_means, rtol=1e-4, atol=0.0)):
        raise AssertionError(f"channel means {means.tolist()} vs plain {want_means.tolist()}")
    max_err = float((img[..., :3] - want).abs().max())
    n_samples = RES[0] * RES[1] * SPP
    work = _path_work(tb, lanes, mat)
    tests = work["tests"]
    nbytes = _nbytes(lanes, mat, carry0.f, carry0.i, carry0.f, carry0.i, tb.scene, tb.bn)
    tests_ms, _by = _bound(tests, nbytes)
    bound_ms, bound_by, terms = _loop_bound(work, nbytes)
    plan = kernels.path_loop.plan
    resident = plan["block"] * plan["blocks_per_sm"] * plan["sms"]
    print(f"[6 main] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material via "
          f"Scene.render: {launches} path_loop launch(es), plain version not called; channel "
          f"means {[round(x, 6) for x in means.tolist()]} vs plain (rtol 1e-4), max abs diff "
          f"{max_err:.3e}; Scene.render median {ms:.2f} ms of {[round(t, 2) for t in times]} "
          f"(first {first_ms:.2f} ms) = {n_samples / ms / 1e3:.2f} M samples/s; kernel alone "
          f"{kernel_ms:.2f} ms (CUDA events, median of 5) = {n_samples / kernel_ms / 1e3:.2f} M "
          f"samples/s; plain {plain_ms:.2f} ms = {n_samples / plain_ms / 1e3:.3f} M samples/s; "
          f"launch {plan['block']} threads a block (of up to {plan['max_block']}), "
          f"{plan['registers']} registers, "
          f"{plan['local_bytes']} bytes of local memory (stack and spills) a thread, "
          f"{plan['blocks_per_sm']} blocks an SM, {resident} resident threads, "
          f"{plan['waves']:.3f} waves ({lanes.shape[1]} lanes), {plan['rounds']} rounds; work "
          f"(every 16th lane, scaled): {work['steps']:.4g} steps, {work['restarts']:.4g} "
          f"samples, {tests:.4g} ray-triangle tests -> counted-work bound {bound_ms:.3f} ms "
          f"({max(terms, key=terms.get)}: " + ", ".join(f"{k} {v:.3f}" for k, v in terms.items())
          + f" ms), the tests' bound {tests_ms:.3f} ms; card {smi}", flush=True)
    return dict(launches=launches, max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                plain_shape=f"{RES[0]}x{RES[1]} {SPP} spp", bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, bound_terms_ms=terms,
                bound_tests_ms=tests_ms, plan=plan)


def _assert_grad_close(got, want, what):
    """Per-channel sums within rtol 1e-5, and every texel whose gradient
    (largest |channel|) passes 1e-3 of the largest within rtol 1e-4 of it.
    Not bit-exact: the kernel's float atomics, and the plain version's
    index_add_, sum the taps in a run-dependent order, and the kernel's
    derivatives are written by hand where the plain version's are torch's.
    -> (max abs error, worst texel's relative error)."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite gradient")
    sums, want_sums = got.double().sum((0, 1)), want.double().sum((0, 1))
    if not bool(torch.allclose(sums, want_sums, rtol=1e-5, atol=0.0)):
        raise AssertionError(f"{what}: channel sums {sums.tolist()} vs plain {want_sums.tolist()}")
    mag = want.abs().amax(-1)
    if float(mag.max()) == 0.0:
        raise AssertionError(f"{what}: the plain gradient is zero, nothing to compare")
    big = mag > 1e-3 * float(mag.max())
    rel = (got - want).abs().amax(-1)[big] / mag[big]
    worst = float(rel.max())
    if worst > 1e-4:
        raise AssertionError(f"{what}: {int((rel > 1e-4).sum())} of {int(big.sum())} texels "
                             f"past rtol 1e-4 (worst {worst:.3e})")
    return float((got - want).abs().max()), worst


def phase_grad(dev):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _flagship(dev)
    mat = _material(4, dev, tex=64)
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config((128, 128), 16), 6)
    lanes = pl.pixel_lanes(tb.res, tb.spp, dev)
    le = torch.as_tensor(np.random.RandomState(3).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    fwd = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    notes = []
    # the launch's own near rows, and every row in global scratch (k_cap 0)
    for k_cap in (None, 0):
        got, carry, _c, plan = kernels.grad_launch(kernels.load_library(), tb, lanes, mat, le,
                                                   tb.n_steps, k_cap)
        torch.cuda.synchronize()
        if not torch.equal(carry.f[0:3], fwd.f[0:3]):
            raise AssertionError("path_loop_grad: its radiance differs from the forward kernel's")
        max_err, worst = _assert_grad_close(got, want, f"path_loop_grad 128x128 k {plan['k_near']}")
        notes.append(f"{plan['k_near']} near rows: channel sums "
                     f"{[round(x, 6) for x in got.double().sum((0, 1)).tolist()]} (rtol 1e-5), "
                     f"worst texel rel err {worst:.3e} (rtol 1e-4), max abs diff {max_err:.3e}")
    print(f"[7 grad] 128x128 16 spp 64^2 material, random adjoint: kernel vs plain backward "
          f"with " + "; with ".join(notes) + "; the kernel's radiance equals the forward "
          f"kernel's bit for bit", flush=True)


def phase_main_grad(dev, smi):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _flagship(dev)
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()

    def iteration():
        mat.grad = None
        loss = scene.render(mat, res=RES, spp=SPP, seed=0)[..., :3].sum()
        loss.backward()
        return loss

    plain = (pl.loop_step.calls, pl.render_path_loop_plain.calls,
             pl.render_path_backward_loop_plain.calls)
    (loss, first_ms), counts = _drive_main(lambda: _sync_ms(iteration))
    launches = (counts["path_loop"], counts["path_loop_grad"])
    if min(launches) < 1:
        raise AssertionError(f"the main path's launches (path_loop, path_loop_grad): {launches}")
    if (pl.loop_step.calls, pl.render_path_loop_plain.calls,
            pl.render_path_backward_loop_plain.calls) != plain:
        raise AssertionError("the main path's iteration ran a plain version")
    grad = mat.grad.detach().clone()
    if tuple(grad.shape) != (TEX, TEX, 4) or not bool(torch.isfinite(grad).all()):
        raise AssertionError(f"main path gradient: shape {tuple(grad.shape)} or non-finite")
    if float(grad.abs().max()) == 0.0:
        raise AssertionError("main path gradient is zero")

    # the same backward by the plain version: seed + 1, adjoint 1 / spp
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(RES, SPP), 1)
    lanes = pl.pixel_lanes(RES, SPP, dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / SPP, device=dev)
    m = mat.detach()
    (want, _), plain_ms = _sync_ms(
        lambda: pl.render_path_backward_loop_plain(tb, lanes, m, le, tb.n_steps))
    max_err, worst = _assert_grad_close(grad, want, "main path gradient")
    plan = kernels.path_loop_grad.plan

    it_ms, it_runs = _median_ms(iteration)
    grad_ms, grad_runs = _event_ms(lambda: kernels.path_loop_grad(tb, lanes, m, le, tb.n_steps))
    n_samples = RES[0] * RES[1] * SPP
    tests = _path_work(tb, lanes, m)["tests"]
    carry0 = pl.init_carry(lanes)
    bound_ms, bound_by = _bound(tests, _nbytes(lanes, m, le, carry0.f, carry0.i, carry0.f,
                                               carry0.i, grad, tb.scene, tb.bn))
    print(f"[8 main-grad] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material, "
          f"loss = image[..., :3].sum(), loss.backward(): {launches[0]} path_loop and "
          f"{launches[1]} path_loop_grad launch(es), no plain version called; loss "
          f"{float(loss.detach()):.4f}; gradient vs plain backward: worst texel rel err {worst:.3e}, max "
          f"abs diff {max_err:.3e}; iteration median {it_ms:.2f} ms of "
          f"{[round(t, 2) for t in it_runs]} (first {first_ms:.2f} ms); path_loop_grad alone "
          f"median {grad_ms:.2f} ms of {[round(t, 2) for t in grad_runs]} (CUDA events) = "
          f"{n_samples / grad_ms / 1e3:.2f} M samples/s; plain backward {plain_ms:.2f} ms (one "
          f"run); {tests:.4g} ray-triangle tests (every 16th lane, scaled) -> bound "
          f"{bound_ms:.3f} ms ({bound_by}); launch {_plan_note(plan)}; card {smi}", flush=True)
    return dict(launches=launches[1], max_abs_err=max_err, ms=grad_ms, plain_ms=plain_ms,
                plain_shape=f"{RES[0]}x{RES[1]} {SPP} spp", bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, iteration_ms=it_ms, plan=plan)


def _plan_note(plan):
    return (f"{plan['k_near']} tap rows a sample in shared memory, block {plan['block']}, "
            f"{plan['registers']} registers, {plan['blocks_per_sm']} blocks an SM, "
            f"{plan['smem_bytes']} bytes of shared memory a block, {plan['local_bytes']} bytes "
            f"of local memory a thread")


def _random_rays(name, n, seed, dev):
    """n random rays as trace_interact takes them (o3, d3, pdf_prev,
    active): inside the cornell box, or around the sphere aimed near its
    centre; a fifth without a BSDF pdf (1e30), a tenth inactive."""
    g = torch.Generator().manual_seed(seed)
    if name == "cbox":
        lo, hi = torch.tensor([-2.8, 0.2, -5.6]), torch.tensor([2.3, 5.1, -0.4])
        o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
        d = torch.randn((n, 3), generator=g)
    else:
        o = torch.randn((n, 3), generator=g)
        o = 1.6 * o / o.norm(dim=1, keepdim=True)
        d = torch.rand((n, 3), generator=g) - 0.5 - o
    d = d / d.norm(dim=1, keepdim=True)
    pdf = torch.where(torch.rand(n, generator=g) < 0.2, 1e30,
                      0.1 + 9.9 * torch.rand(n, generator=g))
    act = (torch.rand(n, generator=g) > 0.1).to(torch.int32)
    return [x.to(torch.float32).contiguous().to(dev) for x in (*o.T, *d.T, pdf)] + [act.to(dev)]


def phase_trace(dev):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators.bounce import trace_interact_plain
    from zdr_tpu_torch.integrators.scene_tables import scene_table

    n = RES[0] * RES[1]
    worst, notes, record = 0.0, [], None
    for name, scene in (("cbox", _flagship(dev, "direct")), ("sphere", _protocol(dev))):
        table = scene_table(scene._data)
        rays = _random_rays(name, n, 7, dev)
        for lite in (False, True):
            got = kernels.trace_interact(table, rays, lite)
            want = trace_interact_plain(table, rays, lite)
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(got, want)):
                if a.dtype == torch.int32:
                    if not torch.equal(a, b):
                        raise AssertionError(f"trace_interact {name} lite={lite}: int plane {k} "
                                             f"differs in {int((a != b).sum())} rays")
                elif not bool(torch.isclose(a, b, rtol=1e-6, atol=1e-6).all()):
                    raise AssertionError(f"trace_interact {name} lite={lite}: float plane {k} "
                                         f"max diff {float((a - b).abs().max()):.3e}")
                else:
                    worst = max(worst, float((a - b).abs().max()))
        ms, _runs = _event_ms(lambda: kernels.trace_interact(table, rays))
        plain_ms = _sync_ms(lambda: trace_interact_plain(table, rays))[1]
        notes.append(f"{name} ({table.shape[0]} tris): kernel {ms:.3f} ms, plain {plain_ms:.2f} ms")
        if name == "sphere":
            bound_ms, bound_by = _bound(n * table.shape[0],
                                        _nbytes(table, *rays) + 16 * n * 4)
            record = dict(launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          plain_shape=f"{n} rays x {table.shape[0]} triangles",
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(f"[9 trace_interact] {n} random rays, full and lite, kernel vs plain: ints equal, "
          f"floats within atol 1e-6 rtol 1e-6 (max diff {worst:.3e}); full mode "
          + "; ".join(notes) + f"; 962-triangle bound {record['bound_ms']:.3f} ms "
          f"({record['bound_by']})", flush=True)
    return record


def phase_direct(dev):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    res, spp = (128, 128), 16
    out = {}
    for name, scene in (("cbox", _flagship(dev, "direct")), ("sphere", _protocol(dev))):
        tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 5)
        lanes = pl.pixel_lanes(res, spp, dev)
        mat = _material(3, dev)
        got = kernels.direct(tb, lanes, mat)
        want, plain_ms = _sync_ms(lambda: dr.render_direct_plain(tb, lanes, mat))
        diff = (got - want).abs().amax(0) / spp
        mean, within = float(diff.mean()), float((diff <= 1e-5).float().mean())
        if not (mean <= 1e-6 and within >= 0.999):
            raise AssertionError(f"direct {name} 128x128: mean abs diff {mean:.3e}, "
                                 f"{within:.4%} within 1e-5")
        gmat = _material(4, dev, tex=64)
        le = torch.as_tensor(np.random.RandomState(3).rand(3, lanes.shape[1]).astype(np.float32),
                             device=dev)
        grad, acc = kernels.direct_grad(tb, lanes, gmat, le)
        fwd = kernels.direct(tb, lanes, gmat)
        (want_g, _acc), gplain_ms = _sync_ms(
            lambda: dr.render_direct_backward_plain(tb, lanes, gmat, le))
        torch.cuda.synchronize()
        if not torch.equal(acc, fwd):
            raise AssertionError(f"direct_grad {name}: its radiance differs from direct's")
        g_err, g_worst = _assert_grad_close(grad, want_g, f"direct_grad {name} 128x128")
        out[name] = dict(err=float((got - want).abs().max() / spp), g_err=g_err)
        print(f"[10 direct] {name} ({tb.scene.shape[0]} tris) 128x128 16 spp: direct vs plain "
              f"mean abs diff {mean:.3e}, {within:.4%} of pixels within 1e-5; direct_grad "
              f"(64^2 material, random adjoint) vs plain backward: channel sums rtol 1e-5, "
              f"worst texel rel err {g_worst:.3e} (rtol 1e-4), max abs diff {g_err:.3e}; "
              f"its radiance equals direct's bit for bit; plain {plain_ms:.1f} ms, plain "
              f"backward {gplain_ms:.1f} ms", flush=True)
    return {k: max(v[k] for v in out.values()) for k in ("err", "g_err")}


def _plain_calls():
    from zdr_tpu_torch.integrators import bounce, collocated as co, direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    return (dr.direct_sample_plain.calls, dr.render_direct_plain.calls,
            dr.render_direct_backward_plain.calls, bounce.trace_interact_plain.calls,
            bounce.shade_plain.calls, co.collocated_sample_plain.calls, pl.loop_step.calls,
            pl.render_path_loop_plain.calls, pl.render_path_backward_loop_plain.calls)


def _direct_main(scene, res, spp, what, smi, reps):
    """One iteration of the direct integrator's main path, checked at every
    CHECK_STRIDE-th lane, then timed -> its numbers."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    dev = scene.device
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()

    def iteration():
        mat.grad = None
        loss = scene.render(mat, res=res, spp=spp, seed=0)[..., :3].sum()
        loss.backward()
        return loss

    plain = _plain_calls()
    (loss, first_ms), counts = _drive_main(lambda: _sync_ms(iteration))
    launches = (counts["direct"], counts["direct_grad"])
    if min(launches) < 1:
        raise AssertionError(f"{what}: launches (direct, direct_grad) {launches}")
    if _plain_calls() != plain:
        raise AssertionError(f"{what}: the iteration ran a plain version")
    grad = mat.grad.detach()
    if tuple(grad.shape) != (TEX, TEX, 4) or not bool(torch.isfinite(grad).all()):
        raise AssertionError(f"{what}: gradient of shape {tuple(grad.shape)} or non-finite")
    if float(grad.abs().max()) == 0.0:
        raise AssertionError(f"{what}: the gradient is zero")
    if not math.isfinite(float(loss.detach())):
        raise AssertionError(f"{what}: non-finite loss")

    # both kernels on the main path's own inputs (its tables, seed 0 for the
    # render and 1 for the backward, its material, the adjoint 1 / spp)
    # against their plain versions at every CHECK_STRIDE-th lane
    m = mat.detach()
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 0)
    tb1 = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 1)
    lanes = pl.pixel_lanes(res, spp, dev)
    sub = lanes[:, ::CHECK_STRIDE].contiguous()
    got = kernels.direct(tb, lanes, m)[:, ::CHECK_STRIDE]
    want, plain_ms = _sync_ms(lambda: dr.render_direct_plain(tb, sub, m))
    diff = (got - want).abs().amax(0) / spp
    mean, within = float(diff.mean()), float((diff <= 1e-5).float().mean())
    if not (mean <= 1e-6 and within >= 0.999):
        raise AssertionError(f"{what}: direct vs plain at every {CHECK_STRIDE}th lane: mean abs "
                             f"diff {mean:.3e}, {within:.4%} within 1e-5")
    le_sub = torch.zeros((3, lanes.shape[1]), device=dev)
    le_sub[:, ::CHECK_STRIDE] = 1.0 / spp
    ggot, _acc = kernels.direct_grad(tb1, lanes, m, le_sub)
    (gwant, _acc), gplain_ms = _sync_ms(lambda: dr.render_direct_backward_plain(
        tb1, sub, m, le_sub[:, ::CHECK_STRIDE].contiguous()))
    g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what}: direct_grad at every "
                                        f"{CHECK_STRIDE}th lane")
    check = (f"at every {CHECK_STRIDE}th lane ({sub.shape[1]} lanes x {spp} spp), direct vs "
             f"plain mean abs diff {mean:.3e}, {within:.4%} within 1e-5, plain {plain_ms:.1f} "
             f"ms; direct_grad vs plain backward worst texel rel err {g_worst:.3e} (rtol 1e-4), "
             f"max abs diff {g_err:.3e}, plain {gplain_ms:.1f} ms")

    it_ms, it_runs = _median_ms(iteration, reps)
    render_ms, render_runs = _median_ms(lambda: scene.render(m, res=res, spp=spp, seed=0), reps)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    ms, _r = _event_ms(lambda: kernels.direct(tb, lanes, m), reps)
    tests, plan = int(kernels.direct.tests), kernels.direct.plan
    gms, _r = _event_ms(lambda: kernels.direct_grad(tb, lanes, m, le), reps)
    gtests = int(kernels.direct_grad.tests)
    acc = torch.empty((3, lanes.shape[1]), device=dev)
    n_samples = res[0] * res[1] * spp
    nbytes = _nbytes(lanes, m, acc, tb.scene, tb.lights, tb.bn)
    gnbytes = _nbytes(lanes, m, le, acc, m, tb.scene, tb.lights, tb.bn)
    stages, sub_tests, stage_note = None, None, ""
    if plan["early"]:
        # the early out's tests by the place they leave, on a stride of the
        # same lanes, which must be the kernel's tests of those lanes
        stages, early_sub = _early_work(tb, lanes, m)
        kernels.direct(tb, early_sub, m)
        sub_tests = int(kernels.direct.tests)
        if int(stages.sum()) != sub_tests:
            raise AssertionError(f"{what}: the early out's stages count {int(stages.sum())} "
                                 f"tests on every {4 * CHECK_STRIDE}th lane, the kernel "
                                 f"{sub_tests}")
        shares = (stages.double() / stages.sum()).tolist()
        stage_note = (f", at every {4 * CHECK_STRIDE}th lane {shares[0]:.4f} of them leave "
                      f"after u's numerator, {shares[1]:.4f} after v's and t's, "
                      f"{shares[2]:.4f} reach the division, {shares[3]:.4f} are the light "
                      f"triangles' whole tests (the kernel's count of those "
                      f"lanes, {sub_tests}, equal): {_test_ops(stages):.2f} FP32 operations "
                      f"a test")
    test_ops = _test_ops(stages)
    bound = _direct_bound(tests, n_samples, nbytes, test_ops=test_ops)
    gbound = _direct_bound(gtests, n_samples, gnbytes, grad=True, test_ops=test_ops)
    bound_tests = _bound(tests, nbytes, ops=test_ops)[0]
    gbound_tests = _bound(gtests, gnbytes, ops=test_ops)[0]
    sweep = "with the early out" if plan["early"] else "without the early out"
    print(f"[11 main-direct] {what}: {tb.scene.shape[0]} tris, pmj02bn {res[0]}x{res[1]} {spp} "
          f"spp {TEX}^2 material of 0.5, loss = image[..., :3].sum(), loss.backward(): "
          f"{launches[0]} direct and {launches[1]} direct_grad launch(es), no plain version "
          f"called; loss {float(loss.detach()):.4f}, gradient finite, |g|max "
          f"{float(grad.abs().max()):.4e}; {check}; iteration median {it_ms:.2f} ms of "
          f"{[round(t, 2) for t in it_runs]} (first {first_ms:.2f} ms); Scene.render median "
          f"{render_ms:.2f} ms of {[round(t, 2) for t in render_runs]}; direct alone "
          f"{ms:.3f} ms = {n_samples / ms / 1e3:.2f} M samples/s ({sweep}, block "
          f"{plan['block']}, {plan['registers']} registers, {plan['blocks_per_sm']} blocks an "
          f"SM, {plan['waves']:.3f} waves), {tests:.4g} ray-triangle tests{stage_note} -> "
          f"counted-work "
          f"bound {bound[0]:.3f} ms ({bound[1]}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in bound[2].items())
          + f"), tests only {bound_tests:.3f} ms; direct_grad alone {gms:.3f} ms, {gtests:.4g} "
          f"tests -> bound {gbound[0]:.3f} ms ({gbound[1]}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in gbound[2].items())
          + f"), tests only {gbound_tests:.3f} ms; plain versions not run at full width; card "
          f"{smi}", flush=True)
    return dict(launches=launches, ms=ms, gms=gms, bound=bound, gbound=gbound,
                iteration_ms=it_ms,
                bound_tests=bound_tests, gbound_tests=gbound_tests, early=plan["early"],
                stages=None if stages is None else stages.tolist(), test_ops=test_ops,
                err=float((got - want).abs().max() / spp), g_err=g_err, plain_ms=plain_ms,
                gplain_ms=gplain_ms,
                plain_shape=f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, {spp} spp")


def _iteration(scene, mat, res, spp):
    """loss = scene.render(mat)[..., :3].sum(); loss.backward() -> loss."""
    def run():
        mat.grad = None
        loss = scene.render(mat, res=res, spp=spp, seed=0)[..., :3].sum()
        loss.backward()
        return loss
    return run


def phase_main_direct(dev, smi):
    """Phase 11: the protocol and the cornell box by the dense route, then
    the protocol by the route accel="auto" takes, the BVH -> (the dense
    kernels' numbers, the BVH kernels' records on the protocol)."""
    proto = _direct_main(_protocol(dev), RES, PROTOCOL_SPP,
                         "the reference's protocol (sphere + quad light)", smi, reps=3)
    cbox = _direct_main(_flagship(dev, "direct"), RES, SPP, "cornell box", smi, reps=5)
    if proto["early"] == cbox["early"]:
        raise AssertionError("phase 11: the protocol and the cornell box took the same sweep; "
                             "each instantiation must run on a main path")
    proto["cornell_box"] = cbox
    for k in ("err", "g_err"):
        proto[k] = max(proto[k], cbox[k])
    auto = _bvh_main(_protocol(dev, accel="auto"), "direct", PROTOCOL_SPP,
                     "11 main-direct", "the protocol with accel='auto'", smi, reps=3)
    proto["auto_ms"] = auto["direct_bvh"]["iteration_ms"]
    return proto, auto


def _bigmesh(device, integrator):
    """tools/bench_bigmesh.py's sphere of 160 x 160 (50,880 triangles) and
    camera, over the protocol's 2-triangle quad light of 40."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_quad, make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5, n_lat=160, n_lon=160), None, None),
                      (make_quad(size=1.0, y=-2.0), None, 40.0)],
                     integrator=integrator, device=device)
    scene.camera = zt.Camera(fov=0.8, origin=(1.5, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    return scene


def _sphere_rays(n, dev):
    """Phase 12's rays: origins at radius 1.6, aimed near the sphere's
    centre; a per-ray t_max in [0.5, 3) for any hit -> (o, d, t_max)."""
    g = torch.Generator().manual_seed(12)
    o = torch.randn((n, 3), generator=g)
    o = (1.6 * o / o.norm(dim=1, keepdim=True)).to(dev)
    d = torch.rand((n, 3), generator=g).to(dev) - 0.5 - o
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    t_max = (0.5 + 2.5 * torch.rand(n, generator=g)).to(dev)
    return o, d, t_max


def phase_trace_bvh(dev, smi):
    """Phase 12: trace_closest and trace_any, dense and BVH, against their
    plain versions bit for bit -> their records (the BVH on the big mesh)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.accel import build_accel
    from zdr_tpu_torch.accel import trace as tt

    n = RES[0] * RES[1]
    o, d, t_max = _sphere_rays(n, dev)
    notes, records = [], {}
    cases = (("protocol", _protocol(dev), "bruteforce"), ("protocol", _protocol(dev), "bvh"),
             ("big mesh", _bigmesh(dev, "direct"), "bvh"))
    for name, scene, method in cases:
        acc = build_accel(scene._data.geom, method)
        runs = {
            "trace_closest": (lambda a=acc: kernels.trace_closest(a, o, d, 0.0, 1e30),
                              lambda a=acc: tt.trace_closest_plain(a, o, d, 0.0, 1e30)),
            "trace_any": (lambda a=acc: (kernels.trace_any(a, o, d, 1e-4, t_max),),
                          lambda a=acc: tt.trace_any_plain(a, o, d, 1e-4, t_max)),
        }
        for kname, (kern, plain) in runs.items():
            got = kern()
            counts = getattr(kernels, kname).counts.tolist()
            (want, work), plain_ms = _sync_ms(plain)
            want = want if kname == "trace_closest" else (want,)
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{kname} {method} on the {name}: {int((a != b).sum())} "
                                         f"of {n} rays differ from the plain version")
            if counts != [int(x) for x in work]:
                raise AssertionError(f"{kname} {method} on the {name}: counts {counts} vs plain "
                                     f"{[int(x) for x in work]}")
            ms, _runs = _event_ms(kern)
            t_range = (0.0, 1e30) if kname == "trace_closest" else (1e-4, t_max)
            bound = _bound(counts[0], _trace_nbytes(kname, acc, o, d, *t_range), counts[1])
            deep = f", BVH {acc.depth} deep" if acc.is_bvh else ""
            notes.append(f"{kname} {method} {name} ({acc.num_triangles} tris{deep}): kernel {ms:.3f} ms, "
                         f"plain {plain_ms:.1f} ms, {counts[0] / n:.1f} tests and {counts[1] / n:.1f} "
                         f"visits a ray, bound {bound[0]:.4f} ms ({bound[1]})")
            if name == "big mesh":
                records[kname] = dict(launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                      plain_shape=f"{n} rays x {acc.num_triangles} triangles (BVH)",
                                      bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                                      tests=counts[0], visits=counts[1])
    print(f"[12 trace] {n} random rays around the sphere, per-ray t_max in [0.5, 3) for any "
          f"hit; kernel vs plain bit for bit, counts equal; " + "; ".join(notes)
          + f"; card {smi}", flush=True)
    return records


def _bvh_check(tb, tb1, mat, integrator, what, stride=None, exact=False,
               samples=CHECK_SAMPLES):
    """Both BVH kernels against their plain walks on the main path's own
    inputs (its tables at seed 0 and 1, its material, the adjoint 1 / spp)
    at every `stride`-th lane (CHECK_STRIDE), the first `samples` samples
    of each, the forward bit for bit where `exact` -> (forward max abs diff
    a sample, gradient max abs diff, a note)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    dev, spp = mat.device, tb.spp
    stride = stride or CHECK_STRIDE
    sub = pl.pixel_lanes(tb.res, samples, dev)[:, ::stride].contiguous()
    le = torch.full((3, sub.shape[1]), 1.0 / spp, device=dev)
    if integrator == "direct":
        got = kernels.direct(tb, sub, mat)
        want, plain_ms = _sync_ms(lambda: dr.render_direct_plain(tb, sub, mat))
        ggot, _acc = kernels.direct_grad(tb1, sub, mat, le)
        (gwant, _acc), gplain_ms = _sync_ms(
            lambda: dr.render_direct_backward_plain(tb1, sub, mat, le))
    elif integrator == "collocated":
        from zdr_tpu_torch.integrators import collocated as co

        got = kernels.collocated(tb, sub, mat)
        want, plain_ms = _sync_ms(lambda: co.render_collocated_plain(tb, sub, mat))
        ggot, _acc = kernels.collocated_grad(tb1, sub, mat, le)
        (gwant, _acc), gplain_ms = _sync_ms(
            lambda: co.render_collocated_backward_plain(tb1, sub, mat, le))
    else:
        got = kernels.path_loop(tb, sub, mat, pl.init_carry(sub), tb.n_steps).f[0:3]
        plain, plain_ms = _sync_ms(lambda: pl.render_path_loop_plain(
            tb, sub, mat, pl.init_carry(sub), tb.n_steps))
        want = plain.f[0:3]
        ggot, _c = kernels.path_loop_grad(tb1, sub, mat, le, tb.n_steps)
        (gwant, _c), gplain_ms = _sync_ms(
            lambda: pl.render_path_backward_loop_plain(tb1, sub, mat, le, tb.n_steps))
    torch.cuda.synchronize()
    diff = (got - want).abs().amax(0) / samples
    mean, within = float(diff.mean()), float((diff <= 1e-5).float().mean())
    if not (mean <= 1e-6 and within >= 0.999):
        raise AssertionError(f"{what} {integrator}: kernel vs plain mean abs diff {mean:.3e}, "
                             f"{within:.4%} within 1e-5")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{what} {integrator}: {int((got != want).any(0).sum())} lanes "
                             f"differ from the plain walk (bit for bit expected)")
    g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what} {integrator} gradient")
    note = (f"at every {stride}th lane, the first {samples} samples "
            f"({sub.shape[1]} lanes): forward vs plain mean abs diff {mean:.3e}, bit-identical "
            f"{bool(torch.equal(got, want))}, plain {plain_ms:.1f} ms; gradient worst texel rel "
            f"err {g_worst:.3e} (rtol 1e-4), max abs diff {g_err:.3e}, plain {gplain_ms:.1f} ms")
    return float(diff.max()), g_err, plain_ms, gplain_ms, note


# the BVH instantiations of each integrator: forward, gradient
BVH_KERNELS = {"direct": ("direct_bvh", "direct_grad_bvh"),
               "path": ("path_loop_bvh", "path_loop_grad_bvh")}


def _bvh_main(scene, integrator, spp, tag, what, smi, reps=5):
    """One main path through the BVH kernels: Scene.render + loss.backward()
    of `scene` (pmj02bn, 512x512, `spp`, 1024^2 material of 0.5): one launch
    of each BVH kernel and none of the dense ones, no plain version called;
    both kernels against their plain walks on the main path's own inputs
    (_bvh_check); the iteration's median, Scene.render's and each kernel's
    alone, with its counted tests and node visits -> the two kernels'
    records."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.accel.bvh import MAX_DEPTH
    from zdr_tpu_torch.integrators import path_loop as pl

    fwd, bwd = BVH_KERNELS[integrator]
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=scene.device)
    mat.requires_grad_()
    iteration = _iteration(scene, mat, RES, spp)
    plain = (_plain_calls(), pl.loop_step.calls, pl.render_path_backward_loop_plain.calls)
    (loss, first_ms), counts = _drive_main(lambda: _sync_ms(iteration))
    if (counts[fwd], counts[bwd]) != (1, 1) or any(counts[k] for k in DENSE):
        raise AssertionError(f"{what} {integrator}: launches {counts}; expected one of "
                             f"{fwd} and {bwd} and none of the dense kernels")
    if (_plain_calls(), pl.loop_step.calls, pl.render_path_backward_loop_plain.calls) != plain:
        raise AssertionError(f"{what} {integrator}: the iteration ran a plain version")
    grad = mat.grad.detach()
    if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
            and math.isfinite(float(loss.detach()))):
        raise AssertionError(f"{what} {integrator}: non-finite or zero loss or gradient")

    m, dev = mat.detach(), scene.device
    data = scene._render_data(integrator)
    tb = pl.build_loop_tables(data, scene.camera, scene._config(RES, spp), 0)
    tb1 = pl.build_loop_tables(data, scene.camera, scene._config(RES, spp), 1)
    if tb.bvh is None:
        raise AssertionError(f"{what} {integrator}: not the BVH route")
    err, g_err, plain_ms, gplain_ms, check = _bvh_check(tb, tb1, m, integrator, what)

    it_ms, it_runs = _median_ms(iteration, reps)
    render_ms, _r = _median_ms(lambda: scene.render(m, res=RES, spp=spp, seed=0), reps)
    lanes = pl.pixel_lanes(RES, spp, dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    if integrator == "direct":
        ms, _r = _event_ms(lambda: kernels.direct(tb, lanes, m), reps)
        work = kernels.direct_bvh.counts.tolist()
        gms, _r = _event_ms(lambda: kernels.direct_grad(tb1, lanes, m, le), reps)
        gwork = kernels.direct_grad_bvh.counts.tolist()
        state = [torch.empty((3, lanes.shape[1]), device=dev)]
    else:
        carry0 = pl.init_carry(lanes)
        ms, _r = _event_ms(lambda: kernels.path_loop(tb, lanes, m, carry0, tb.n_steps), reps)
        work = kernels.path_loop_bvh.counts.tolist()
        gms, _r = _event_ms(lambda: kernels.path_loop_grad(tb1, lanes, m, le, tb.n_steps), reps)
        gwork = kernels.path_loop_grad_bvh.counts.tolist()
        state = [carry0.f, carry0.i, carry0.f, carry0.i]
        lp = kernels.path_loop_bvh.plan
        check += (f"; {fwd} launch {lp['block']} threads a block (of up to "
                  f"{lp['max_block']}), {lp['registers']} registers, "
                  f"{lp['local_bytes']} bytes of local memory a thread, {lp['blocks_per_sm']} "
                  f"blocks an SM, {lp['waves']:.3f} waves, {lp['rounds']} rounds; {bwd} launch "
                  f"{_plan_note(kernels.path_loop_grad_bvh.plan)}")
    a = tb.bvh
    tables = (lanes, m, tb.scene, tb.lights, tb.bn, a.geom, a.nodes)
    bound = _bound(work[0], _nbytes(*tables, *state), work[1])
    gbound = _bound(gwork[0], _nbytes(*tables, le, m, *state), gwork[1])
    n_samples = RES[0] * RES[1] * spp
    print(f"[{tag}] {what}, {integrator}: {tb.scene.shape[0]} tris, BVH of "
          f"{a.nodes.shape[0]} nodes (leaf {a.leaf_size}, {a.depth} deep of the walk's "
          f"{MAX_DEPTH}), pmj02bn {RES[0]}x{RES[1]} {spp} spp {TEX}^2 "
          f"material of 0.5, loss = image[..., :3].sum(), loss.backward(): 1 {fwd} and 1 "
          f"{bwd} launch, no dense kernel, no plain version; loss "
          f"{float(loss.detach()):.4f}, |g|max {float(grad.abs().max()):.4e}; {check}; "
          f"iteration median {it_ms:.2f} ms of {[round(t, 2) for t in it_runs]} (first "
          f"{first_ms:.2f} ms); Scene.render median {render_ms:.2f} ms; {fwd} alone {ms:.2f} "
          f"ms = {n_samples / ms / 1e3:.2f} M samples/s, {work[0]:.4g} tests and {work[1]:.4g} "
          f"node visits ({work[0] / n_samples:.1f} and {work[1] / n_samples:.1f} a sample) "
          f"-> bound {bound[0]:.3f} ms ({bound[1]}); {bwd} alone {gms:.2f} ms, "
          f"{gwork[0]:.4g} tests, {gwork[1]:.4g} visits -> bound {gbound[0]:.3f} ms "
          f"({gbound[1]}); card {smi}", flush=True)
    shape = (f"every {CHECK_STRIDE}th lane of {RES[0]}x{RES[1]}, the first {CHECK_SAMPLES} "
             f"of {spp} samples")
    return {fwd: dict(launches=counts[fwd], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      plain_shape=shape, bound_ms=bound[0], bound_by=bound[1],
                      library_ms=None, tests=work[0], visits=work[1], iteration_ms=it_ms),
            bwd: dict(launches=counts[bwd], max_abs_err=g_err, ms=gms, plain_ms=gplain_ms,
                      plain_shape=shape, bound_ms=gbound[0], bound_by=gbound[1],
                      library_ms=None, tests=gwork[0], visits=gwork[1])}


def _emissive(device, integrator):
    """An emissive uv sphere of 48 x 48 (4512 light triangles, 288,768 bytes
    of light rows: past a block's shared memory) over a floor quad,
    accel="auto" (tests/test_torch_emissive.py's scene)."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_quad, make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5, 48, 48), None, 4.0),
                      (make_quad(size=2.0, y=-0.7), None, None)],
                     integrator=integrator, device=device)
    scene.camera = zt.Camera(fov=0.9, origin=(1.6, 0.6, 0.4), target=(0.0, -0.3, 0.0))
    return scene


def phase_emissive(dev, smi):
    """Phase 16: the emissive sphere at 128x128, 16 spp, by accel="auto",
    both integrators, Scene.render + loss.backward(): one launch of each BVH
    kernel with the small tables in global memory and none of the dense
    ones, no plain version called; both kernels against their plain walks on
    the main path's own inputs at every 8th lane, the first CHECK_SAMPLES
    samples (phase 10's and phase 7's bars)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.integrators.scene_tables import SCENE_COLS, table_floats

    res, spp = (128, 128), 16
    for integrator in ("direct", "path"):
        scene = _emissive(dev, integrator)
        meta = scene._data.meta
        small = table_floats(meta) - meta.num_tris * SCENE_COLS
        if len(meta.light_tri_ids) != 4512 or kernels.small_tables_shared(small):
            raise AssertionError("the emissive sphere's light rows fit shared memory")
        fwd, bwd = BVH_KERNELS[integrator]
        mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()
        plain = (_plain_calls(), pl.loop_step.calls, pl.render_path_backward_loop_plain.calls)
        (loss, ms), counts = _drive_main(lambda: _sync_ms(_iteration(scene, mat, res, spp)))
        if (counts[fwd], counts[bwd]) != (1, 1) or any(counts[k] for k in DENSE):
            raise AssertionError(f"emissive sphere {integrator}: launches {counts}")
        if (_plain_calls(), pl.loop_step.calls, pl.render_path_backward_loop_plain.calls) != plain:
            raise AssertionError(f"emissive sphere {integrator}: a plain version ran")
        grad = mat.grad.detach()
        if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
                and math.isfinite(float(loss.detach()))):
            raise AssertionError(f"emissive sphere {integrator}: non-finite or zero gradient")
        data = scene._render_data(integrator)
        tb = pl.build_loop_tables(data, scene.camera, scene._config(res, spp), 0)
        tb1 = pl.build_loop_tables(data, scene.camera, scene._config(res, spp), 1)
        _err, _g_err, _p, _gp, note = _bvh_check(tb, tb1, mat.detach(), integrator,
                                                 "emissive sphere", stride=8)
        print(f"[16 emissive] a uv sphere of 4512 emissive triangles ({small * 4} bytes of "
              f"small tables, read from global memory) over a floor, {integrator}, pmj02bn "
              f"{res[0]}x{res[1]} {spp} spp {TEX}^2 material of 0.5 by accel='auto', "
              f"Scene.render + loss.backward(): 1 {fwd} and 1 {bwd} launch, no dense kernel, "
              f"no plain version; loss {float(loss.detach()):.4f}, |g|max "
              f"{float(grad.abs().max()):.4e}, first iteration {ms:.1f} ms; {note}; card {smi}",
              flush=True)


def phase_bigmesh(dev, smi):
    """Phase 13: the 50,880-triangle scene through Scene.render +
    loss.backward() for both integrators -> the BVH kernels' records."""
    records = {}
    for integrator in ("direct", "path"):
        scene = _bigmesh(dev, integrator)
        if scene._data.meta.num_tris != 50882:
            raise AssertionError("the big mesh is not 50,882 triangles")
        records.update(_bvh_main(scene, integrator, SPP, "13 big mesh", "big mesh", smi))
    return records

# FP32 operations of one Woop test (woop_hit in kernels/csrc/sweep_variants.cuh),
# counted as MT_OPS is (no comparisons): three 4-dots with their offset (3
# products and 3 sums each), three 3-dots (5 each), the division and the
# negation, two scale-and-adds and u + v
WOOP_OPS = 40
# the BVH leaf widths phase 14 walks (production's is accel/build.BVH_LEAF)
LEAF_WIDTHS = (2, 4, 8, 16)
# the B9 measurement kernels, on no main path
VARIANTS = ("sweep_variant", "woop_sweep", "aabb_sweep", "floor_probe")
# phase 14 times each variant by the median of VARIANT_REPS runs
VARIANT_REPS = 10


def _same(got, want):
    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _variant_run(what, wrapper, call, want, work, ops, nbytes, n, floor_ms, exact=True,
                 visit_ops=SLAB_OPS):
    """One grid point of a sweep variant (or a walk at a leaf width, whose
    visits cost visit_ops): bit for bit against its plain version with
    equal counts (not `exact`, the epilogue modes: ints equal, floats at
    phase 9's bar), then timed -> (ms, bound, its line)."""
    got = call()
    torch.cuda.synchronize()
    counts = wrapper.counts.tolist()
    if not _same(got, want):
        if exact:
            raise AssertionError(f"{what}: differs from its plain version")
        for k, (a, b) in enumerate(zip(got, want)):
            if a.dtype == torch.int32 and not torch.equal(a, b):
                raise AssertionError(f"{what}: int plane {k} differs from the plain version")
            if a.dtype != torch.int32 and not bool(torch.isclose(a, b, rtol=1e-6, atol=1e-6).all()):
                raise AssertionError(f"{what}: float plane {k} max diff "
                                     f"{float((a - b).abs().max()):.3e}")
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
        what += f" (floats within atol 1e-6 rtol 1e-6, max diff {worst:.3e})"
    if counts != [int(x) for x in work]:
        raise AssertionError(f"{what}: counts {counts} vs plain {[int(x) for x in work]}")
    ms, _runs = _event_ms(call, VARIANT_REPS)
    bound = _bound(counts[0], nbytes, counts[1], ops, visit_ops)
    boxes = f" + {counts[1] / n:.2f} box tests" if counts[1] else ""
    line = (f"{what}: {ms:.4f} ms, {counts[0] / n:.1f} tests{boxes} a ray, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), {ms / floor_ms:.1f}x floor_probe's time a call")
    return ms, bound, line


def phase_variants(dev, smi):
    """Phase 14: the sweep variants (B9's counterparts) on the protocol's
    962 triangles and 262,144 rays of each set, every grid point bit for bit
    against its plain version, timed; then the BVH leaf widths -> the four
    kernels' records."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.accel import build_accel
    from zdr_tpu_torch.accel import trace as tt
    from zdr_tpu_torch.accel import variants as tv
    from zdr_tpu_torch.accel.woop import tile_boxes, woop_rows
    from zdr_tpu_torch.integrators.scene_tables import scene_table

    scene = _protocol(dev)
    table = scene_table(scene._data)
    acc = build_accel(scene._data.geom, "bruteforce")
    geom, woop = acc.geom, woop_rows(acc.geom)
    n = RES[0] * RES[1]
    prim = tv.primary_rays(scene, RES)
    sets = {"primary": prim, "bounce": tv.bounce_rays(n, dev),
            "shadow": tv.shadow_rays(geom, table, prim)}

    # the floor: out = a + b over two ray planes, through the same harness
    a, b = prim[0][0].contiguous(), prim[0][3].contiguous()
    if not torch.equal(kernels.floor_probe(a, b), a + b):
        raise AssertionError("floor_probe differs from a + b")
    floor_ms = _event_ms(lambda: kernels.floor_probe(a, b), VARIANT_REPS)[0]
    floor_plain = _sync_ms(lambda: a + b)[1]
    floor_library = _event_ms(lambda: torch.add(a, b), VARIANT_REPS)[0]
    # the device's time a call, the same way for both: a CUDA graph of
    # GRAPH_CALLS launches replayed between one event pair, FLOOR_ROUNDS
    # rounds in turns (each first in every other round), the median
    dev_ms = {"floor_probe": [], "torch.add": []}
    calls = {"floor_probe": lambda: kernels.floor_probe(a, b),
             "torch.add": lambda: torch.add(a, b)}
    for r in range(FLOOR_ROUNDS):
        for name in sorted(calls, reverse=r % 2 == 1):  # which goes first alternates
            dev_ms[name].append(_graph_ms(calls[name]))
    floor_dev, add_dev = (statistics.median(dev_ms[k]) for k in ("floor_probe", "torch.add"))
    bound = _bound(0, 3 * n * 4)
    records = {"floor_probe": dict(
        launches=None, max_abs_err=0.0, ms=floor_ms, plain_ms=floor_plain,
        plain_shape=f"{n} floats", bound_ms=bound[0], bound_by=bound[1],
        library_ms=floor_library, device_ms=floor_dev, library_device_ms=add_dev)}
    print(f"[14 variants] {scene._data.meta.num_tris} tris, {n} rays a set (primary: the "
          f"protocol camera's lcg primaries at seed 1; bounce: uniform directions at radius "
          f"0.52; shadow: from the primaries' hits to the quad light, t_max its distance); "
          f"floor_probe a call {floor_ms:.4f} ms (CUDA events around the Python call, median "
          f"of {VARIANT_REPS}; plain a + b {floor_plain:.4f} ms by the host clock, torch.add "
          f"{floor_library:.4f} ms the same way); on the device, a CUDA graph of "
          f"{GRAPH_CALLS} calls a replay: floor_probe {floor_dev:.5f} ms a call (runs "
          f"{[round(x, 5) for x in dev_ms['floor_probe']]}), torch.add {add_dev:.5f} ms "
          f"({[round(x, 5) for x in dev_ms['torch.add']]}); bound {bound[0]:.4f} ms "
          f"({bound[1]}); the variants' 'x the floor' divide by floor_probe's time a call; "
          f"card {smi}", flush=True)
    outs = {"closest": 16, "any": 4, "interact": 64, "lite": 16}

    def keep(name, ms, plain_ms, bound, point):
        """The kernel's record: its fastest point on the primaries."""
        if name not in records or ms < records[name]["ms"]:
            records[name] = dict(launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 plain_shape=f"{n} primary rays x {geom.shape[0]} triangles",
                                 bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                                 point=point)

    for set_name, (rays, act) in sets.items():
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        modes = ("any",) if set_name == "shadow" else ("closest", "interact", "lite")
        lines = []
        for mode in modes:
            exact = mode in ("closest", "any")
            nbytes = _nbytes(rays, act, geom) + outs[mode] * n + (
                _nbytes(table) if mode in ("interact", "lite") else 0)
            (want, work), plain_ms = _sync_ms(
                lambda: tv.sweep_variant_plain(geom, table, rays, act, mode))
            if mode in ("closest", "any"):
                dense = (kernels.trace_closest(acc, o, d, 0.0, rays[7]) if mode == "closest"
                         else kernels.trace_any(acc, o, d, 1e-4, rays[7]))
                if not _same(dense, want):
                    raise AssertionError(f"accel.cu's dense trace_{mode} differs from the "
                                         f"plain sweep on the {set_name} rays")
            for m, tile, r, use_woop, cull in kernels.variant_points():
                if m != mode or use_woop or cull:
                    continue
                what = f"sweep_variant {mode} kTile {tile} R {r}"
                ms, bnd, line = _variant_run(
                    what, kernels.sweep_variant,
                    lambda: kernels.sweep_variant(geom, table, rays, act, mode, tile, r),
                    want, work, MT_OPS, nbytes, n, floor_ms, exact)
                lines.append(line)
                if set_name == "primary" and mode == "closest":
                    keep("sweep_variant", ms, plain_ms, bnd, f"closest kTile {tile} R {r}")
            # the Woop test, and what its winners do against MT's
            (wwant, wwork), wplain = _sync_ms(
                lambda: tv.woop_sweep_plain(woop, geom, table, rays, act, mode))
            ms, bnd, line = _variant_run(
                f"woop_sweep {mode} kTile 512", kernels.woop_sweep,
                lambda: kernels.woop_sweep(woop, geom, table, rays, act, mode),
                wwant, wwork, WOOP_OPS, nbytes + _nbytes(geom), n, floor_ms, exact)
            if mode == "closest":
                same = wwant[1] == want[1]
                for k in (0, 2, 3):
                    if not torch.equal(wwant[k][same], want[k][same]):
                        raise AssertionError(f"woop_sweep {set_name}: t, u or v differs from "
                                             "MT's where the winner is the same")
                line += (f"; winner differs from MT's on {int((~same).sum())} of {n} rays "
                         f"({float((~same).float().mean()):.3e})")
                if set_name == "primary":
                    keep("woop_sweep", ms, wplain, bnd, "closest kTile 512")
            elif mode == "any":
                line += (f"; occlusion differs from MT's on {int((wwant != want).sum())} of "
                         f"{n} rays")
            lines.append(line)
            if mode not in ("closest", "any"):
                continue
            # the tile culls, MT and Woop: the unculled sweep's hits, fewer tests
            for m, tile, _r, use_woop, cull in kernels.variant_points():
                if m != mode or not cull:
                    continue
                rows = woop if use_woop else geom
                boxes = tile_boxes(geom, tile)
                (awant, awork), aplain = _sync_ms(lambda: tv.aabb_sweep_plain(
                    rows, geom, boxes, tile, rays, act, mode, use_woop))
                if not _same(awant, wwant if use_woop else want):
                    raise AssertionError(f"aabb_sweep plain {mode} kTile {tile} woop "
                                         f"{use_woop}: differs from the unculled sweep")
                test = "Woop" if use_woop else "MT"
                ms, bnd, line = _variant_run(
                    f"aabb_sweep {mode} {test} kTile {tile}", kernels.aabb_sweep,
                    lambda: kernels.aabb_sweep(rows, geom, boxes, tile, rays, act, mode,
                                               use_woop),
                    awant, awork, WOOP_OPS if use_woop else MT_OPS,
                    nbytes + _nbytes(boxes), n, floor_ms)
                lines.append(line)
                if set_name == "primary" and mode == "closest":
                    keep("aabb_sweep", ms, aplain, bnd, f"closest {test} kTile {tile}")
        print(f"[14 variants] {set_name} rays, each against its plain version with equal "
              f"counts, bit for bit unless marked (the MT closest and any sweeps also equal "
              f"accel.cu's dense trace kernels): " + "; ".join(lines), flush=True)

    # the BVH's leaf width: the trace kernels on phase 12's rays
    o, d, t_max = _sphere_rays(n, dev)
    for name, sc in (("protocol", scene), ("big mesh", _bigmesh(dev, "direct"))):
        lines = []
        for leaf in LEAF_WIDTHS:
            bvh = tv.leaf_accel(sc._data.geom, leaf)
            parts = []
            for kname, call, plain in (
                    ("closest", lambda: kernels.trace_closest(bvh, o, d, 0.0, 1e30),
                     lambda: tt.trace_closest_plain(bvh, o, d, 0.0, 1e30)),
                    ("any", lambda: (kernels.trace_any(bvh, o, d, 1e-4, t_max),),
                     lambda: tt.trace_any_plain(bvh, o, d, 1e-4, t_max))):
                wrapper = getattr(kernels, f"trace_{kname}")
                want, work = plain()
                want = want if kname == "closest" else (want,)
                ms, bnd, _line = _variant_run(f"trace_{kname} leaf {leaf} {name}", wrapper, call,
                                              want, work, MT_OPS, 0, n, floor_ms,
                                              visit_ops=VISIT_OPS)
                tests, visits = (int(x) for x in work)
                parts.append(f"{kname} {ms:.4f} ms, {tests / n:.1f} tests + {visits / n:.1f} "
                             f"visits a ray")
            lines.append(f"leaf {leaf} ({bvh.nodes.shape[0]} nodes, {bvh.depth} deep): "
                         + ", ".join(parts))
        print(f"[14 leaf width] {name} ({sc._data.meta.num_tris} tris), {n} random rays, "
              f"trace_closest / trace_any through the BVH built at each leaf width, bit for bit "
              f"against the plain walk with equal counts: " + "; ".join(lines), flush=True)
    return records


# phase 15's scenes, by sphere stacks (None: the cornell box, 12 triangles)
# over the protocol's quad light: 26, 50, 122, 226 and 962 (the protocol's)
# triangles; for direct 38, between the sizes where its routes meet, 3970
# (where a route disagreement once showed in the gradient alone); and the
# largest that each integrator's dense kernels hold in shared memory
# (kernels.check_table_fits): 4762 direct, 1850 path
_SMALL_STACKS = (None, (3, 6), (4, 8), (6, 12), (8, 16), (16, 32))
CROSS_STACKS = {"direct": _SMALL_STACKS[:2] + ((4, 6),) + _SMALL_STACKS[2:] + ((32, 64),
                                                                              (36, 68)),
                "path": _SMALL_STACKS + ((22, 44),)}


def phase_crossover(dev, smi):
    """Phase 15: each integrator's iteration (Scene.render + loss.backward(),
    pmj02bn, 512x512, 64 spp, 1024^2 material of 0.5; median of 5) by the
    dense route and by the BVH at each scene size: the images equal bit for
    bit, the gradients at phase 7's bars -> the crossover a route."""
    from zdr_tpu_torch.accel.build import DENSE_MAX_TRIS

    found = {}
    for integrator, stacks_list in CROSS_STACKS.items():
        table = []
        for stacks in stacks_list:
            ms, img, grad, depth = {}, {}, {}, None
            for accel in ("bruteforce", "bvh"):
                sc = (_flagship(dev, integrator, accel) if stacks is None
                      else _protocol(dev, accel, integrator, stacks))
                acc = sc._render_data(integrator).accel
                if (acc is not None) != (accel == "bvh"):
                    raise AssertionError(f"crossover: accel={accel!r} took the other route")
                depth = acc.depth if acc is not None else depth
                mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32,
                                 device=dev).requires_grad_()
                # the first iteration, kept, is the warm-up of the timed five
                image = sc.render(mat, res=RES, spp=SPP, seed=0)
                image[..., :3].sum().backward()
                img[accel], grad[accel] = image.detach(), mat.grad.detach().clone()
                run = _iteration(sc, mat, RES, SPP)
                ms[accel] = statistics.median(_sync_ms(run)[1] for _ in range(5))
            n_tris = sc._data.meta.num_tris
            if not torch.equal(img["bvh"], img["bruteforce"]):
                bad = int((img["bvh"] != img["bruteforce"]).any(-1).sum())
                raise AssertionError(f"crossover {integrator} {n_tris} tris: the BVH image "
                                     f"differs from the dense one in {bad} pixels")
            _g_err, g_worst = _assert_grad_close(grad["bvh"], grad["bruteforce"],
                                                 f"crossover {integrator} {n_tris} tris")
            table.append((n_tris, ms["bruteforce"], ms["bvh"], g_worst, depth))
        # the smallest size from which the BVH is faster at every larger size,
        # and where the two times meet, linearly between it and the size before
        k = len(table)
        while k and table[k - 1][2] < table[k - 1][1]:
            k -= 1
        if k == len(table):
            verdict = "the dense route is faster at the largest size"
        elif k == 0:
            verdict = "the BVH is faster at every size"
        else:
            (n0, d0, b0, _w, _h), (n1, d1, b1, _w, _h) = table[k - 1], table[k]
            meet = n0 + (d0 - b0) * (n1 - n0) / ((b1 - b0) - (d1 - d0))
            verdict = (f"the BVH is faster from {n1} triangles on; the times meet at "
                       f"{meet:.1f} triangles")
        found[integrator] = table[k][0] if k < len(table) else None
        rows = "; ".join(f"{t} tris: dense {a:.2f} ms, BVH ({h} deep) {b:.2f} ms ({a / b:.2f}x), "
                         f"gradient worst texel {w:.2e}" for t, a, b, w, h in table)
        print(f"[15 crossover] {integrator}, pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 "
              f"material of 0.5, iteration median of 5, images bit for bit and gradients at "
              f"phase 7's bars: {rows}; {verdict} (accel/build.DENSE_MAX_TRIS[{integrator!r}] "
              f"= {DENSE_MAX_TRIS[integrator]}); card {smi}", flush=True)
    return found


# the kernels of phases 17-19 by slice and route: forward, gradient
SLICE_KERNELS = {("collocated", "dense"): ("collocated", "collocated_grad"),
                 ("collocated", "bvh"): ("collocated_bvh", "collocated_grad_bvh"),
                 ("direct", "dense"): ("direct_env", "direct_grad_env"),
                 ("direct", "bvh"): ("direct_env_bvh", "direct_grad_env_bvh"),
                 ("path", "dense"): ("path_loop_env", "path_loop_grad_env"),
                 ("path", "bvh"): ("path_loop_env_bvh", "path_loop_grad_env_bvh")}
# the flagship's own kernels, which phase 20 drives through _slice_main with
# the other samplers
FLAGSHIP_KERNELS = {("path", "dense"): ("path_loop", "path_loop_grad")}


def _golden_sphere(device, integrator, accel):
    """tools/gen_golden.py's uv sphere (16 x 32, 960 triangles) and sphere
    camera."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5), None, None)], integrator=integrator, accel=accel,
                     device=device)
    scene.camera = zt.Camera(fov=0.8, origin=(1.2, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    return scene


def _example(device):
    """apps/example.py's scene: the 960-triangle uv sphere under
    make_test_envmap(256, 512), the direct integrator, its camera."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.envmap import make_test_envmap
    from zdr_tpu_torch.geometry.procedural import make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5), None, None)], integrator="direct", device=device)
    scene.add_envmap(make_test_envmap(256, 512))
    scene.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(1.0, 0.0, 0.0),
                             target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return scene


# the path walk's shadow counts of _path_work that the records carry
PATH_SHADOW_KEYS = ("shadow_walked", "shadow_skipped", "below_env", "below_mesh")


def _path_walk_counts(tb, lanes, mat):
    """The plain walk of what the path BVH kernels walk on `lanes` (tables
    with a BVH): each step a lane runs (a sample left, or in flight) its
    next ray's closest hit, and a shading lane's shadow ray, under an env
    only where the light sample lies above the hemisphere, each through
    accel/trace.py's ordered walk, which counts as the kernels do; the
    other rays are not walked (their results are read nowhere) -> {tests,
    visits, steps, shadow_walks}."""
    from zdr_tpu_torch.accel import trace as ttrace
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.microfacet import make_onb, to_local

    if tb.bvh is None:
        raise ValueError("_path_walk_counts walks a BVH")
    fi, ii = pl.F_IDX, pl.I_IDX
    out = dict(tests=0, visits=0, steps=0, shadow_walks=0)
    mask = {}

    def add(work):
        out["tests"] += int(work[0])
        out["visits"] += int(work[1])

    def occluded(scene, p, wi, dist, bvh=None):
        m = mask["walk"]
        occ = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
        if bool(m.any()):
            hit, work = ttrace.bvh_any(bvh, tuple(x[m] for x in p), tuple(x[m] for x in wi),
                                       torch.full_like(dist[m], 1e-4), dist[m])
            occ[m] = hit
            add(work)
        return occ

    def closest_hit(scene, o, d, bvh=None):
        m = mask["run"]
        best_t = torch.full_like(o[0], pl.T_MAX)
        bu, bv = torch.zeros_like(best_t), torch.zeros_like(best_t)
        prim = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
        if bool(m.any()):
            zero = torch.zeros_like(best_t[m])
            (t, p_, u, v), work = ttrace.bvh_closest(bvh, tuple(x[m] for x in o),
                                                     tuple(x[m] for x in d), zero, zero + pl.T_MAX)
            best_t[m], bu[m], bv[m], prim[m] = t, u, v, p_.to(torch.int64)
            add(work)
        return best_t, bu, bv, prim

    carry = pl.init_carry(lanes)
    saved = pl.occluded, pl.closest_hit
    pl.occluded, pl.closest_hit = occluded, closest_hit
    try:
        for _ in range(tb.n_steps):
            flying = carry.i[ii["in_flight"]] != 0
            run = (carry.i[ii["sample_idx"]] < lanes[2]) | flying
            if not bool(run.any()):
                break
            walk = run & flying & (carry.i[ii["shade"]] != 0)
            if tb.env is not None:
                ns = tuple(carry.f[fi[k]] for k in ("ns_x", "ns_y", "ns_z"))
                wl = tuple(carry.f[fi[k]] for k in ("wl_x", "wl_y", "wl_z"))
                t_, b_ = make_onb(ns)
                walk = walk & (to_local(t_, b_, ns, wl)[2] >= 1e-4)
            mask.update(run=run, walk=walk)
            out["steps"] += int(run.sum())
            out["shadow_walks"] += int(walk.sum())
            carry = pl.loop_step(carry, tb, lanes, mat)
    finally:
        pl.occluded, pl.closest_hit = saved
    return out


def _shadow_path_note(work, n_samples):
    """The path walk's shadow rays walked and skipped a sample, and its
    light samples below the hemisphere by kind."""
    return (f"{work['shadow_walked'] / n_samples:.3f} shadow walks and "
            f"{work['shadow_skipped'] / n_samples:.3f} skipped a sample; light samples below "
            f"the hemisphere {work['below_env'] / n_samples:.3f} env and "
            f"{work['below_mesh'] / n_samples:.3f} mesh or point a sample, of "
            f"{(work['shadow_walked'] + work['shadow_skipped']) / n_samples:.3f} shading steps")


def _tap_note(taps, n_samples):
    """The path gradient's counted taps a sample (_TapWork.scaled)."""
    return (f"taps a sample: {taps['rows'] / n_samples:.3f} rows written "
            f"({taps['row_bytes_shared'] / 1e6:.1f} MB in shared memory, "
            f"{taps['row_bytes_global'] / 1e6:.1f} MB in global scratch), "
            f"{taps['replayed'] / n_samples:.3f} replayed, {taps['atomics'] / n_samples:.3f} "
            f"16-byte atomics")


def _slice_kernels(integrator):
    """The wrappers a slice's forward and gradient run by, as (tb, lanes,
    mat) -> (3, N) radiance sums and (tb, lanes, mat, le) -> (gradient,
    _), and their plain versions likewise."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import collocated as co
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    if integrator == "collocated":
        return (kernels.collocated, kernels.collocated_grad, co.render_collocated_plain,
                co.render_collocated_backward_plain)
    if integrator == "direct":
        return (kernels.direct, kernels.direct_grad, dr.render_direct_plain,
                dr.render_direct_backward_plain)

    def fwd(tb, lanes, m):
        return kernels.path_loop(tb, lanes, m, pl.init_carry(lanes), tb.n_steps).f[0:3]

    def fwd_plain(tb, lanes, m):
        return pl.render_path_loop_plain(tb, lanes, m, pl.init_carry(lanes), tb.n_steps).f[0:3]

    return (fwd, lambda tb, lanes, m, le: kernels.path_loop_grad(tb, lanes, m, le, tb.n_steps),
            fwd_plain,
            lambda tb, lanes, m, le: pl.render_path_backward_loop_plain(tb, lanes, m, le,
                                                                        tb.n_steps))


def _slice_main(scene, res, spp, tex, tag, what, smi, reps=3, work_stride=16,
                check_samples=CHECK_SAMPLES, env_stride=ENV_WORK_STRIDE, work_bvh=False):
    """One main path of phases 17-20, Scene.render + loss.backward() of
    `scene` (its sampler, `res`, `spp`, a tex^2 material of 0.5) by the
    route its accel takes: one launch of each of its two kernels
    (SLICE_KERNELS; FLAGSHIP_KERNELS for the path integrator without an
    env) and of no other, no plain version called; both kernels against their
    plain versions on the main path's own inputs at every CHECK_STRIDE-th
    lane (the dense kernels over all the samples, the BVH kernels over the
    first check_samples), the forward bit for bit and the gradient at phase
    7's bars; the iteration's median, Scene.render's and each kernel's
    alone, with its counted work (the path walk's on every work_stride-th
    lane, over the dense tables or, with work_bvh, through the route's BVH;
    the path gradient's taps on its check's lanes, _TapWork; the direct
    env's on every env_stride-th lane) and bound -> (the two kernels'
    records, the image rendered at seed 0)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    integrator, dev = scene.integrator, scene.device
    data = scene._render_data(integrator)
    route = "bvh" if data.accel is not None else "dense"
    own = integrator == "path" and data.env is None
    fwd, bwd = (FLAGSHIP_KERNELS if own else SLICE_KERNELS)[integrator, route]
    mat = torch.full((tex, tex, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()
    iteration = _iteration(scene, mat, res, spp)
    plain = _plain_calls()
    (loss, first_ms), counts = _drive_main(lambda: _sync_ms(iteration))
    others = {k: v for k, v in counts.items() if v and k not in (fwd, bwd)}
    if (counts[fwd], counts[bwd]) != (1, 1) or others:
        raise AssertionError(f"{what}: launches {counts}; expected one of {fwd} and {bwd} and "
                             f"no other")
    if _plain_calls() != plain:
        raise AssertionError(f"{what}: the iteration ran a plain version")
    grad = mat.grad.detach()
    if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
            and math.isfinite(float(loss.detach()))):
        raise AssertionError(f"{what}: non-finite or zero loss or gradient")

    m = mat.detach()
    tb = pl.build_loop_tables(data, scene.camera, scene._config(res, spp), 0)
    tb1 = pl.build_loop_tables(data, scene.camera, scene._config(res, spp), 1)
    lanes = pl.pixel_lanes(res, spp, dev)
    fkern, gkern, fplain, gplain = _slice_kernels(integrator)
    n_samples = res[0] * res[1] * spp
    # the path gradient's taps, counted by the plain backward of the check
    # on its lanes and samples
    taps = _TapWork()
    n_checked = len(range(0, res[0] * res[1], CHECK_STRIDE))
    if route == "bvh":
        with taps:
            err, g_err, plain_ms, gplain_ms, check = _bvh_check(
                tb, tb1, m, integrator, what, exact=True, samples=check_samples)
        tap_scale = n_samples / (n_checked * check_samples)
        shape = (f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, the first "
                 f"{check_samples} of {spp} samples")
    else:
        sub = lanes[:, ::CHECK_STRIDE].contiguous()
        got = fkern(tb, lanes, m)[:, ::CHECK_STRIDE]
        if integrator == "path" and work_stride == CHECK_STRIDE:
            # the walk that counts the work on these lanes is the plain
            # forward: its time is the plain version's with the counting
            walked = []
            path_work, plain_ms = _sync_ms(
                lambda: _path_work(tb, lanes, m, stride=work_stride, carry_out=walked))
            want = walked[0].f[0:3]
            counted = " (the walk that counts the work)"
        else:
            want, plain_ms = _sync_ms(lambda: fplain(tb, sub, m))
            counted = ""
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {fwd} vs plain at every {CHECK_STRIDE}th lane: "
                                 f"{int((got != want).any(0).sum())} lanes differ")
        le_sub = torch.zeros((3, lanes.shape[1]), device=dev)
        le_sub[:, ::CHECK_STRIDE] = 1.0 / spp
        ggot, _acc = gkern(tb1, lanes, m, le_sub)
        with taps:
            (gwant, _acc), gplain_ms = _sync_ms(
                lambda: gplain(tb1, sub, m, le_sub[:, ::CHECK_STRIDE].contiguous()))
        tap_scale = n_samples / (n_checked * spp)
        g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what}: {bwd}")
        err = 0.0
        shape = f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, {spp} spp{counted}"
        check = (f"at every {CHECK_STRIDE}th lane ({sub.shape[1]} lanes x {spp} spp) {fwd} "
                 f"equals its plain version bit for bit, plain {plain_ms:.1f} ms{counted}; {bwd} "
                 f"vs plain "
                 f"worst texel rel err {g_worst:.3e} (rtol 1e-4), max abs diff {g_err:.3e}, "
                 f"plain {gplain_ms:.1f} ms")

    it_ms, it_runs = _median_ms(iteration, reps)
    image = scene.render(m, res=res, spp=spp, seed=0)
    render_ms, _r = _median_ms(lambda: scene.render(m, res=res, spp=spp, seed=0), reps)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    # the state a launch reads and writes: the sums, or the path loop's carry
    if integrator == "path":
        carry0 = pl.init_carry(lanes)
        state = [carry0.f, carry0.i, carry0.f, carry0.i]
        ms, _r = _event_ms(lambda: kernels.path_loop(tb, lanes, m, carry0, tb.n_steps), reps)
    else:
        state = [torch.empty((3, lanes.shape[1]), device=dev)]
        ms, _r = _event_ms(lambda: fkern(tb, lanes, m), reps)
    fk, gk = getattr(kernels, fwd), getattr(kernels, bwd)
    gms, _r = _event_ms(lambda: gkern(tb1, lanes, m, le), reps)
    tables = [lanes, m, tb.scene, tb.lights, tb.bn]
    if tb.env is not None:
        tables += [tb.env.texture, tb.env.alias_prob, tb.env.alias_idx, tb.env.pdf]
    # the env's work: its misses' lookups and its light samples, counted on a
    # stride of the lanes by the plain walk over the dense tables (the
    # routes' walks are equal)
    dense_tb = dataclasses.replace(tb, bvh=None)
    if integrator == "path":
        if not (route == "dense" and work_stride == CHECK_STRIDE):
            path_work = _path_work(tb if work_bvh else dense_tb, lanes, m, stride=work_stride)
        env_work = {k: path_work[k] for k in ("env_miss", "env_nee")}
        tap_work = taps.scaled(tap_scale, gk.plan["k_near"])
    elif integrator == "direct":
        # the route's own tables: the plain BVH walk counts as the dense one
        # and stays quick on the big mesh
        env_work = _direct_env_work(tb, lanes, m, stride=env_stride)
    else:
        env_work = {}
    env_note = "" if not env_work else (
        f"; the env's work: {env_work['env_miss'] / n_samples:.3f} misses' lookups and "
        f"{env_work['env_nee'] / n_samples:.3f} env light samples a sample (counted on a "
        f"stride of the lanes), {_env_ops(env_work) / n_samples:.1f} FP32 operations a sample")
    if route == "bvh":
        tables += [tb.bvh.geom, tb.bvh.nodes]
        work, gwork = fk.counts.tolist(), gk.counts.tolist()
        nbytes, gnbytes = _nbytes(*tables, *state), _nbytes(*tables, le, m, *state)
        if integrator == "path":
            # the walk's counted work with the kernels' own tests and visits
            bound = _loop_bound(dict(path_work, tests=work[0], visits=work[1]), nbytes)
            gbound = _loop_bound(dict(path_work, tests=gwork[0], visits=gwork[1]), gnbytes,
                                 tap_work)
        else:
            bound = _bound(work[0], nbytes, work[1], extra_ops=_env_ops(env_work))
            gbound = _bound(gwork[0], gnbytes, gwork[1], extra_ops=_env_ops(env_work, grad=True))
        work_note = (f"{work[0]:.4g} tests and {work[1]:.4g} node visits ({work[0] / n_samples:.2f}"
                     f" and {work[1] / n_samples:.2f} a sample){env_note}")
        extra = dict(tests=work[0], visits=work[1], **env_work)
        gextra = dict(tests=gwork[0], visits=gwork[1], **env_work)
        if integrator == "path":
            lp, gp = fk.plan, gk.plan
            work_note += (f"; {_shadow_path_note(path_work, n_samples)}; {fwd} launch "
                          f"{lp['block']} threads a block, {lp['registers']} "
                          f"registers, {lp['local_bytes']} bytes of local memory a thread, "
                          f"{lp['waves']:.3f} waves; {bwd} launch {_plan_note(gp)}; "
                          f"{_tap_note(tap_work, n_samples)}")
            shadow = {k: path_work[k] for k in PATH_SHADOW_KEYS}
            extra.update(bound_terms_ms=bound[2], steps=path_work["steps"], **shadow)
            gextra.update(bound_terms_ms=gbound[2], steps=path_work["steps"], taps=tap_work,
                          **shadow)
    elif integrator == "path":
        # the walk's counted work bounds both kernels, the gradient's with
        # its taps
        nbytes = _nbytes(*tables, *state)
        bound = _loop_bound(path_work, nbytes)
        gbound = _loop_bound(path_work, _nbytes(*tables, le, m, *state), tap_work)
        lp, gp = fk.plan, gk.plan
        work_note = (f"{path_work['tests']:.4g} tests, {path_work['steps']:.4g} steps "
                     f"({path_work['steps'] / n_samples:.2f} a sample, "
                     f"{path_work['rounds'] / n_samples:.3f} rejection rounds a sample; every "
                     f"{work_stride}th lane, scaled)"
                     f"{env_note}; {_shadow_path_note(path_work, n_samples)}; {fwd} launch "
                     f"{lp['block']} threads a block, "
                     f"{lp['registers']} registers, {lp['local_bytes']} bytes of local memory a "
                     f"thread, {lp['waves']:.3f} waves; {bwd} launch {_plan_note(gp)}; "
                     f"{_tap_note(tap_work, n_samples)}")
        shadow = {k: path_work[k] for k in PATH_SHADOW_KEYS}
        extra = dict(tests=path_work["tests"], steps=path_work["steps"],
                     rounds=path_work["rounds"], bound_terms_ms=bound[2], **env_work, **shadow)
        gextra = dict(tests=path_work["tests"], steps=path_work["steps"],
                      bound_terms_ms=gbound[2], taps=tap_work, **env_work, **shadow)
    else:
        acc = state[0]
        tests, gtests, plan = int(fk.tests), int(gk.tests), fk.plan
        if integrator == "collocated":
            bound = _collocated_bound(tests, n_samples, _nbytes(*tables, acc))
            gbound = _collocated_bound(gtests, n_samples, _nbytes(*tables, le, acc, m), True)
            test_ops, stage_note = MT_OPS, ""
        else:
            stages, stage_note = None, ""
            if plan["early"]:
                stages, early_sub = _early_work(tb, lanes, m)
                kernels.direct(tb, early_sub, m)
                if int(stages.sum()) != int(fk.tests):
                    raise AssertionError(f"{what}: the early out's stages count "
                                         f"{int(stages.sum())} tests, the kernel {int(fk.tests)}")
                shares = (stages.double() / stages.sum()).tolist()
                stage_note = (f", {shares[0]:.4f} of them leave after u's numerator, "
                              f"{shares[1]:.4f} after v's and t's, {shares[2]:.4f} reach the "
                              f"division, {shares[3]:.4f} are the light triangles' tests")
                fk.tests = tests
            test_ops = _test_ops(stages)
            bound = _direct_bound(tests, n_samples, _nbytes(*tables, acc), test_ops=test_ops,
                                  env_work=env_work)
            gbound = _direct_bound(gtests, n_samples, _nbytes(*tables, le, acc, m), True,
                                   test_ops, env_work)
        work_note = (f"{tests:.4g} tests ({tests / n_samples:.1f} a sample){stage_note}, "
                     f"{test_ops:.2f} FP32 operations a test, block {plan['block']}, "
                     f"{plan['registers']} registers, {plan['waves']:.3f} waves{env_note}")
        extra = dict(tests=tests, test_ops=test_ops, bound_terms_ms=bound[2], **env_work)
        gextra = dict(tests=gtests, test_ops=test_ops, bound_terms_ms=gbound[2], **env_work)
    print(f"[{tag}] {what}: {tb.scene.shape[0]} tris, {route}, {tb.kind} {res[0]}x{res[1]} {spp} "
          f"spp, {tex}^2 material of 0.5, loss = image[..., :3].sum(), loss.backward(): 1 {fwd} "
          f"and 1 {bwd} launch, no other kernel, no plain version; loss "
          f"{float(loss.detach()):.4f}, |g|max {float(grad.abs().max()):.4e}; {check}; "
          f"iteration median {it_ms:.2f} ms of {[round(t, 2) for t in it_runs]} (first "
          f"{first_ms:.2f} ms); Scene.render median {render_ms:.2f} ms; {fwd} alone {ms:.3f} ms "
          f"= {n_samples / ms / 1e3:.2f} M samples/s, {work_note} -> bound {bound[0]:.3f} ms "
          f"({bound[1]}); {bwd} alone {gms:.3f} ms -> bound {gbound[0]:.3f} ms ({gbound[1]}); "
          f"card {smi}", flush=True)
    return {fwd: dict(launches=counts[fwd], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      plain_shape=shape, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                      iteration_ms=it_ms, render_ms=render_ms, **extra),
            bwd: dict(launches=counts[bwd], max_abs_err=g_err, ms=gms, plain_ms=gplain_ms,
                      plain_shape=shape, bound_ms=gbound[0], bound_by=gbound[1],
                      library_ms=None, **gextra)}, image


def phase_collocated(dev, smi):
    """Phase 17: the collocated integrator. The main path: the big-mesh
    bench's sphere (tools/bench_bigmesh.py:27-29: 160 x 160, 50,880
    triangles, its camera) at 512x512, 64 spp with a 1024^2 material, by
    accel="auto" (the BVH); then the golden sphere (960 triangles) by the
    dense route and by the BVH, whose images must be equal bit for bit
    (_slice_main each) -> the four kernels' records (the BVH ones of the big
    mesh, the golden sphere's beside them)."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_uv_sphere

    big = zt.Scene([(make_uv_sphere(0.5, n_lat=160, n_lon=160), None, None)],
                   integrator="collocated", device=dev)
    big.camera = zt.Camera(fov=0.8, origin=(1.5, 0.2, 0.0), target=(0.0, 0.0, 0.0))
    if big._data.meta.num_tris != 50880:
        raise AssertionError("the big-mesh sphere is not 50,880 triangles")
    records, _img = _slice_main(big, RES, SPP, TEX, "17 collocated", "the big mesh", smi)
    golden = _golden_sphere(dev, "collocated", "bruteforce")
    dense, img_dense = _slice_main(golden, RES, SPP, TEX, "17 collocated",
                                   "the golden sphere, dense", smi)
    golden.accel = "auto"
    bvh, img_bvh = _slice_main(golden, RES, SPP, TEX, "17 collocated",
                               "the golden sphere, accel='auto'", smi)
    if not torch.equal(img_dense, img_bvh):
        raise AssertionError(f"collocated golden sphere: the dense and BVH images differ in "
                             f"{int((img_dense != img_bvh).any(-1).sum())} pixels")
    print(f"[17 collocated] the golden sphere's images by the dense route and by the BVH are "
          f"equal bit for bit", flush=True)
    records.update(dense)
    for k, v in bvh.items():
        records[k]["golden_sphere"] = v
    return records


def phase_env(dev, smi):
    """Phase 18: the direct integrator under an envmap. The main path:
    apps/example.py's full-size iteration (_example: 512x512, 64 spp, a
    512^2 material) by accel="auto" (the BVH) and by "bruteforce" (the dense
    env instantiation with the early out) (_slice_main each); then the
    dense instantiation without the early out, the cornell box under the
    same envmap at 128x128, 16 spp, against its plain version (phase 10's
    check) -> the four kernels' records."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    scene = _example(dev)
    records, img_bvh = _slice_main(scene, RES, SPP, 512, "18 env", "apps/example.py", smi)
    scene.accel = "bruteforce"
    dense, img_dense = _slice_main(scene, RES, SPP, 512, "18 env",
                                   "apps/example.py, accel='bruteforce'", smi)
    if not torch.equal(img_dense, img_bvh):
        raise AssertionError(f"example: the dense and BVH images differ in "
                             f"{int((img_dense != img_bvh).any(-1).sum())} pixels")
    records.update(dense)

    from zdr_tpu_torch.envmap import make_test_envmap

    box = _flagship(dev, "direct")
    box.add_envmap(make_test_envmap(256, 512))
    res, spp = (128, 128), 16
    tb = pl.build_loop_tables(box._data, box.camera, box._config(res, spp), 5)
    lanes = pl.pixel_lanes(res, spp, dev)
    mat = _material(3, dev, tex=64)
    got = kernels.direct(tb, lanes, mat)
    if kernels.direct_env.plan["early"]:
        raise AssertionError("the cornell box under the envmap took the early out")
    want = dr.render_direct_plain(tb, lanes, mat)
    le = torch.as_tensor(np.random.RandomState(3).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    grad, acc = kernels.direct_grad(tb, lanes, mat, le)
    want_g, _acc = dr.render_direct_backward_plain(tb, lanes, mat, le)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(acc, got)):
        raise AssertionError("direct_env without the early out differs from its plain version")
    g_err, g_worst = _assert_grad_close(grad, want_g, "direct_grad_env cornell box")
    records["direct_grad_env"]["max_abs_err"] = max(records["direct_grad_env"]["max_abs_err"],
                                                    g_err)
    print(f"[18 env] the example's images by the dense route and by the BVH are equal bit for "
          f"bit; the cornell box under the same envmap ({tb.scene.shape[0]} tris, the dense "
          f"env instantiation without the early out) 128x128 16 spp: direct_env equals its "
          f"plain version bit for bit, direct_grad_env worst texel rel err {g_worst:.3e} (rtol "
          f"1e-4), its radiance equal to direct_env's", flush=True)
    return records


def _env_scene(device):
    """tools/bench_round3.py:39-44's env_scene: a uv sphere of 0.6 at 16 x 32
    (960 triangles) under make_test_envmap(128, 256), its camera; the path
    integrator by accel="auto" (the BVH)."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.envmap import make_test_envmap
    from zdr_tpu_torch.geometry.procedural import make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.6, n_lat=16, n_lon=32), None, None)], "path",
                     device=device)
    scene.camera = zt.Camera(fov=0.9, origin=(0.0, 0.3, 2.0), target=(0.0, 0.0, 0.0))
    scene.add_envmap(make_test_envmap(128, 256))
    return scene


def phase_path_env(dev, smi):
    """Phase 19: the path integrator under an envmap. The flagship under
    make_test_envmap(256, 512) by the dense route (path_loop_env,
    path_loop_grad_env) and tools/bench_round3.py's env_scene by accel="auto"
    (the BVH: path_loop_env_bvh, path_loop_grad_env_bvh), at the flagship's
    512x512, 64 spp, 1024^2 material (_slice_main each); then the cornell
    box under the same envmap at 128x128, 16 spp by both routes, the BVH
    forced: the images equal bit for bit, the gradients at phase 7's bars,
    each gradient kernel's radiance equal to its forward's -> the four
    kernels' records."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.envmap import make_test_envmap
    from zdr_tpu_torch.integrators import path_loop as pl

    box = _flagship(dev)
    box.add_envmap(make_test_envmap(256, 512))
    records, _img = _slice_main(box, RES, SPP, TEX, "19 path-env",
                                "the flagship under make_test_envmap(256, 512)", smi)
    sphere = _env_scene(dev)
    if sphere._render_data("path").accel is None:
        raise AssertionError("env_scene: accel='auto' did not take the BVH")
    bvh, _img = _slice_main(sphere, RES, SPP, TEX, "19 path-env",
                            "tools/bench_round3.py's env_scene, accel='auto'", smi)
    records.update(bvh)

    res, spp = (128, 128), 16
    mat = _material(3, dev, tex=64)
    lanes = pl.pixel_lanes(res, spp, dev)
    le = torch.as_tensor(np.random.RandomState(3).rand(3, lanes.shape[1]).astype(np.float32),
                         device=dev)
    out = {}
    for accel in ("bruteforce", "bvh"):
        box.accel = accel
        tb = pl.build_loop_tables(box._render_data("path"), box.camera, box._config(res, spp), 5)
        if (tb.bvh is not None) != (accel == "bvh"):
            raise AssertionError(f"the cornell box under the envmap: not the {accel} route")
        img = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps).f[0:3]
        grad, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
        out[accel] = (img, grad, carry.f[0:3])
    torch.cuda.synchronize()
    (img_d, grad_d, acc_d), (img_b, grad_b, acc_b) = out["bruteforce"], out["bvh"]
    if not torch.equal(img_d, img_b):
        raise AssertionError(f"the cornell box under the envmap: the dense and BVH images "
                             f"differ in {int((img_d != img_b).any(0).sum())} lanes")
    if not (torch.equal(acc_d, img_d) and torch.equal(acc_b, img_b)):
        raise AssertionError("path_loop_grad_env: its radiance differs from the forward's")
    g_err, g_worst = _assert_grad_close(grad_b, grad_d, "path_loop_grad_env_bvh vs dense")
    for k in ("path_loop_grad_env", "path_loop_grad_env_bvh"):
        records[k]["max_abs_err"] = max(records[k]["max_abs_err"], g_err)
    print(f"[19 path-env] the cornell box under the same envmap ({box._data.meta.num_tris} "
          f"tris) 128x128 16 spp, forced through the BVH: path_loop_env_bvh's image equals "
          f"path_loop_env's bit for bit, the gradients worst texel rel err {g_worst:.3e} "
          f"(rtol 1e-4), each gradient kernel's radiance equal to its forward's", flush=True)
    return records


# phase 20's checks: corrmj in the loop-free form and the generic one, and
# pmj02bn's generic permutation, through each kernel family on the first
# SAMPLER_SAMPLES samples of every SAMPLER_STRIDE-th lane of SAMPLER_RES
# (the plain walks step all their lanes while any runs)
SAMPLER_CHECKS = (("corrmj", 16), ("corrmj", 12), ("pmj02bn", 12))
SAMPLER_RES, SAMPLER_STRIDE, SAMPLER_SAMPLES = (128, 128), 64, 4
# the families: (integrator, the routes held to one plain version, under the
# envmap); the flagship's dense path kernels are held at full width too,
# by SAMPLER_RUNS
SAMPLER_FAMILIES = (("path", ("bruteforce", "bvh"), False),
                    ("direct", ("bruteforce", "bvh"), False),
                    ("collocated", ("bruteforce", "bvh"), False),
                    ("path", ("bruteforce",), True))
# and its full-width runs: the flagship with each of these samplers
SAMPLER_RUNS = (("corrmj", SPP), ("pmj02bn", 96), ("corrmj", 96))


def _sampler_check(scene, kind, spp, routes, mat, what):
    """Scene's integrator with sampler `kind` at SAMPLER_RES, `spp`, by
    each of `routes` (accel): each route's two kernels on the first
    SAMPLER_SAMPLES samples of every SAMPLER_STRIDE-th lane against one
    plain version, the first route's (the routes' walks are equal): the
    forward bit for bit, the gradient at phase 7's bars (a random adjoint),
    the gradient kernel's radiance the forward's -> [(the kernels' names,
    the gradient's worst texel rel err, max abs diff)], a route each."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    scene.sampler = kind
    integrator, dev = scene.integrator, scene.device
    sub = pl.pixel_lanes(SAMPLER_RES, min(spp, SAMPLER_SAMPLES), dev)[:, ::SAMPLER_STRIDE]
    sub = sub.contiguous()
    le = torch.as_tensor(np.random.RandomState(spp).rand(3, sub.shape[1]).astype(np.float32),
                         device=dev)
    fkern, gkern, fplain, gplain = _slice_kernels(integrator)
    want = gwant = None
    out = []
    for accel in routes:
        scene.accel = accel
        data = scene._render_data(integrator)
        if (data.accel is not None) != (accel == "bvh"):
            raise AssertionError(f"{what}: {integrator} did not take the {accel} route")
        tb = pl.build_loop_tables(data, scene.camera, scene._config(SAMPLER_RES, spp), 0)
        tb1 = pl.build_loop_tables(data, scene.camera, scene._config(SAMPLER_RES, spp), 1)
        for k in KERNELS:
            getattr(kernels, k).launches = 0
        got, (ggot, acc) = fkern(tb, sub, mat), gkern(tb1, sub, mat, le)
        ran = sorted(k for k in KERNELS if getattr(kernels, k).launches)
        if want is None:
            want, (gwant, _acc) = fplain(tb, sub, mat), gplain(tb1, sub, mat, le)
        fwd1 = fkern(tb1, sub, mat)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {ran} forward vs plain: "
                                 f"{int((got != want).any(0).sum())} of {sub.shape[1]} lanes "
                                 f"differ")
        acc = acc.f[0:3] if integrator == "path" else acc
        if not torch.equal(acc, fwd1):
            raise AssertionError(f"{what}: {ran} the gradient kernel's radiance differs from "
                                 f"the forward's")
        g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what}: {ran} gradient")
        out.append((ran, g_worst, g_err))
    return out


def phase_samplers(dev, smi, flag, flag_grad, probes, ptxas):
    """Phase 20: the samplers on the render paths. For each of
    SAMPLER_CHECKS, every kernel family of SAMPLER_FAMILIES against its
    plain version (_sampler_check): path_loop / path_loop_grad, direct /
    direct_grad and collocated / collocated_grad by both routes (the
    cornell box, the BVH forced), and path_loop_env / path_loop_grad_env
    (the cornell box under make_test_envmap(64, 128)); then SAMPLER_RUNS at
    full width through _slice_main (the forward bit for bit and the
    gradient at phase 7's bars at every CHECK_STRIDE-th lane, the counted
    work on the same lanes by the same plain walk), each beside the pmj02bn
    SPP flagship (phases 6 and 8: `flag`, `flag_grad`), a time a sample
    each, with the rejection
    rounds of the probes at 96 and 65 spp (phase 3) and the kGen
    instantiations' ptxas -> {"checks": ..., "runs": ...}."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.envmap import make_test_envmap

    env_box = _flagship(dev)
    env_box.add_envmap(make_test_envmap(64, 128))
    mat = _material(7, dev, tex=64)
    checks = {}
    for kind, spp in SAMPLER_CHECKS:
        notes = []
        t0 = time.perf_counter()
        for integrator, routes, env in SAMPLER_FAMILIES:
            scene = env_box if env else _flagship(dev, integrator)
            for ran, worst, err in _sampler_check(scene, kind, spp, routes, mat,
                                                  f"phase 20 {kind} {spp} spp"):
                checks[f"{kind}_{spp}_{'_'.join(ran)}"] = dict(worst_texel_rel=worst,
                                                               max_abs=err)
                notes.append(f"{'+'.join(ran)} (worst texel {worst:.2e})")
        print(f"[20 samplers] {kind} at {spp} spp, {SAMPLER_RES[0]}x{SAMPLER_RES[1]}, the "
              f"first {SAMPLER_SAMPLES} samples of every {SAMPLER_STRIDE}th lane: forwards bit "
              f"for bit their plain versions (each route's against the first's), gradients at "
              f"phase 7's bars: " + ", ".join(notes)
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    for spp in (96, 65):
        print(f"[20 samplers] rejection rounds past the first a generic permutation at {spp} "
              f"spp (phase 3's probe, plain): " + "; ".join(
                  f"{kind} mean {probes[f'{kind}_{spp}']['rounds_mean']:.3f} most "
                  f"{probes[f'{kind}_{spp}']['rounds_most']}" for kind in ("corrmj", "pmj02bn")),
              flush=True)
    gen = {k: v for k, v in ptxas.items() if k.endswith("_gen")}
    print(f"[20 samplers] the kGen instantiations' registers, local bytes and spill bytes: "
          f"{json.dumps(gen)}", flush=True)
    n_flag = RES[0] * RES[1] * SPP
    runs = {}
    for kind, spp in SAMPLER_RUNS:
        t0 = time.perf_counter()
        scene = _flagship(dev)
        scene.sampler = kind
        recs, _img = _slice_main(scene, RES, spp, TEX, "20 samplers",
                                 f"the flagship with {kind} at {spp} spp", smi,
                                 work_stride=CHECK_STRIDE)
        f, g = recs["path_loop"], recs["path_loop_grad"]
        plan, gplan = kernels.path_loop.plan, kernels.path_loop_grad.plan
        n = RES[0] * RES[1] * spp
        runs[f"{kind}_{spp}"] = r = dict(
            spp=spp, launches=f["launches"], grad_launches=g["launches"],
            iteration_ms=f["iteration_ms"], ms=f["ms"], grad_ms=g["ms"],
            ns_a_sample=f["iteration_ms"] * 1e6 / n, bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], bound_terms_ms=f["bound_terms_ms"],
            grad_bound_ms=g["bound_ms"], steps=f["steps"], rounds=f["rounds"],
            max_abs_err=f["max_abs_err"], grad_max_abs_err=g["max_abs_err"],
            plain_ms=f["plain_ms"], grad_plain_ms=g["plain_ms"], plain_shape=f["plain_shape"])
        print(f"[20 samplers] the flagship with {kind} at {spp} spp beside pmj02bn {SPP}: "
              f"iteration {r['iteration_ms']:.2f} ms = {r['ns_a_sample']:.3f} ns a sample "
              f"(pmj02bn {SPP} spp: {flag_grad['iteration_ms']:.2f} ms = "
              f"{flag_grad['iteration_ms'] * 1e6 / n_flag:.3f} ns); path_loop alone "
              f"{r['ms']:.3f} ms = {r['ms'] * 1e6 / n:.3f} ns a sample (pmj02bn {SPP}: "
              f"{flag['ms']:.3f} ms = {flag['ms'] * 1e6 / n_flag:.3f} ns), {plan['registers']} "
              f"registers, {plan['local_bytes']} local bytes; path_loop_grad alone "
              f"{r['grad_ms']:.3f} ms (pmj02bn {SPP}: {flag_grad['ms']:.3f} ms), "
              f"{gplan['registers']} registers; {r['steps'] / n:.2f} steps and "
              f"{r['rounds'] / n:.3f} rejection rounds a sample -> counted-work bound "
              f"{r['bound_ms']:.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in r["bound_terms_ms"].items())
              + f" ms); {time.perf_counter() - t0:.1f} s; card {smi}", flush=True)
    return {"checks": checks, "runs": runs}


# phase 21: the unfused estimators around the trace kernels. Their walks
# are plain torch, bound by the host's launches (~35 ms a walk iteration of
# 262,144 lanes on an H100 host, ~3.5 iterations a sample forward and ~7
# backward: ~25 s an iteration at 64 spp), so the full-width drives run at
# UNFUSED_SPP and the checks against the plain traces at UNFUSED_CHECK_RES,
# UNFUSED_CHECK_SPP
UNFUSED_SPP = 4
UNFUSED_CHECK_RES, UNFUSED_CHECK_SPP = (128, 128), 8
TRACES = ("trace_closest", "trace_any")
# the golden bar (tests/test_golden.py:36)
GOLDEN_ATOL, GOLDEN_RTOL = 2e-4, 1e-4
# The unfused walk against the loop route: the two take a hit's point, uv
# and normals and a light sample by different float arithmetic (the loop
# as the fused route's o + t d and uv0 + u du1 + v du2, the walk as JAX's
# unfused estimator, (1 - u - v) p0 + u p1 + v p2), so on a handful of the
# ~10^6 samples a decision flips, worth up to 1/spp of a light's radiance
# in one pixel, and a tap whose stochastic corner draw lies at a weight's
# edge lands one texel over. studies/unfused_flips.py shows it at 4 spp:
# the 6 values past the bar are 2 pixels, each one sample apart (the loop
# kernel equal to its plain version on those lanes), one where the hit
# points, 1e-5 apart by the fourth bounce, fall either side of the light's
# edge at the seventh, one where a shadow ray grazing the ceiling's corner
# is occluded by the walk alone; and 298 of the 369 texels past 1e-4 pair
# with a neighbour whose difference cancels theirs. The image at the
# golden bar on all but LOOP_VALUE_SHARE of its values and within
# LOOP_MEAN_ABS on average (measured at 8 spp: 0 values past the bar, mean
# 1.8e-8; at 4 spp 6 of 786,432 values past it, max 0.060, mean 2.5e-7);
# the gradient's per-channel sums at phase 7's rtol 1e-5 and all but
# LOOP_TEXEL_SHARE of its texels at phase 7's rtol 1e-4 (measured 0.10% at
# 8 spp, 0.057% at 4).
LOOP_VALUE_SHARE, LOOP_MEAN_ABS, LOOP_TEXEL_SHARE = 1e-4, 1e-6, 0.005


class _CountPlainTraces:
    """While entered, `calls` counts the calls of the plain traces, by
    accel/trace.py's names and by those the kernels' wrappers call them by."""

    def __enter__(self):
        from zdr_tpu_torch import kernels
        from zdr_tpu_torch.accel import trace as tt

        self.calls, self.saved = 0, []
        for mod in (kernels, tt):
            for name in ("trace_closest_plain", "trace_any_plain"):
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))

                def wrap(*args, _fn=fn, **kw):
                    self.calls += 1
                    return _fn(*args, **kw)
                setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class _PlainTraces:
    """While entered, the trace kernels' wrappers run their plain versions
    on the card's tensors: the unfused walks' traces by the plain sweeps."""

    def __enter__(self):
        from zdr_tpu_torch import kernels
        from zdr_tpu_torch.accel import trace as tt

        self.saved = (kernels.trace_closest, kernels.trace_any)
        kernels.trace_closest = lambda a, o, d, lo=0.0, hi=1e30: tt.trace_closest_plain(
            a, o, d, lo, hi)[0]
        kernels.trace_any = lambda a, o, d, lo=1e-4, hi=1e30: tt.trace_any_plain(
            a, o, d, lo, hi)[0]
        return self

    def __exit__(self, *exc):
        from zdr_tpu_torch import kernels

        kernels.trace_closest, kernels.trace_any = self.saved


def _render_grad(scene, mat, res, spp, seed=0):
    """Scene.render + loss.backward() -> (image, gradient), both detached."""
    mat.grad = None
    img = scene.render(mat, res=res, spp=spp, seed=seed)
    img[..., :3].sum().backward()
    return img.detach(), mat.grad.clone()


def _times_ms(fn, reps=3):
    """`reps` synchronised runs of fn, warm already, by the host clock ->
    (median ms, runs)."""
    times = [_sync_ms(fn)[1] for _ in range(reps)]
    return statistics.median(times), times


def _trace_profile(fn):
    """The trace kernels' device time in one run of fn by torch.profiler
    (CUPTI) -> {kernel: (launches, mean ms a launch)}, or None where the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {"trace_closest": re.compile(r"(?<![A-Za-z_])(dense|bvh)_kernel<true>"),
             "trace_any": re.compile(r"(?<![A-Za-z_])(dense|bvh)_kernel<false>")}
    out = {k: [0, 0.0] for k in names}
    busy_ms = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        busy_ms += dev_us / 1e3
        for k, pat in names.items():
            if pat.search(ev.key):
                out[k][0] += ev.count
                out[k][1] += dev_us / 1e3
    if not any(v[1] > 0 for v in out.values()):
        return None
    res = {k: (n, ms / n if n else 0.0) for k, (n, ms) in out.items()}
    res["all_kernels_ms"] = busy_ms
    return res


class _TraceCapture:
    """While entered, the path walk's traces (integrators/path.py's
    trace_closest and trace_any, which call the kernels' wrappers) keep the
    arguments of their `at`-th call (a bounce's rays) and pass every call
    on."""

    def __init__(self, at=3):
        self.at, self.seen, self.args = at, {}, {}

    def __enter__(self):
        from zdr_tpu_torch.integrators import path

        self.saved = {k: getattr(path, k) for k in TRACES}
        for k, fn in self.saved.items():
            lo = 0.0 if k == "trace_closest" else 1e-4

            def wrap(accel, o, d, t_min=lo, t_max=1e30, _k=k, _fn=fn):
                self.seen[_k] = self.seen.get(_k, 0) + 1
                if self.seen[_k] == self.at:
                    self.args[_k] = (accel, o, d, t_min, t_max)
                return _fn(accel, o, d, t_min=t_min, t_max=t_max)
            setattr(path, k, wrap)
        return self

    def __exit__(self, *exc):
        from zdr_tpu_torch.integrators import path

        for k, fn in self.saved.items():
            setattr(path, k, fn)


def _trace_records(args, launches, per_launch):
    """Each trace kernel on one of the unfused flagship's own calls (its
    rays, t range and accel): bit for bit and with the same counted work as
    its plain version, and timed -> its record. "ms" is the kernel's device
    time a launch over the walk (per_launch, torch.profiler's), where the
    profiler saw it; "call_ms" the wrapper's call by CUDA events around it,
    whose host work (checks, the t range's broadcast, ctypes) outlasts a
    launch this small."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.accel import trace as tt

    plains = {"trace_closest": tt.trace_closest_plain, "trace_any": tt.trace_any_plain}
    out, notes = {}, []
    for k in TRACES:
        acc, o, d, lo, hi = args[k]
        n = o.shape[0]
        kern = getattr(kernels, k)
        got = kern(acc, o, d, lo, hi)
        counts = kern.counts.tolist()
        (want, work), plain_ms = _sync_ms(lambda: plains[k](acc, o, d, lo, hi))
        got, want = (got, want) if k == "trace_closest" else ((got,), (want,))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase 21 {k}: the unfused flagship's rays differ from the "
                                 "plain version")
        if counts != [int(x) for x in work]:
            raise AssertionError(f"phase 21 {k}: counts {counts} vs plain {work}")
        call_ms, _runs = _event_ms(lambda: kern(acc, o, d, lo, hi))
        ms = per_launch[k][1] if per_launch else call_ms
        bound = _bound(counts[0], _trace_nbytes(k, acc, o, d, lo, hi), counts[1])
        out[k] = dict(launches=launches[k], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      call_ms=call_ms, ms_by="torch.profiler" if per_launch else "events",
                      plain_shape=f"{n} rays of the unfused flagship x {acc.num_triangles} "
                                  f"triangles ({acc.method}), its bounce call",
                      bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                      tests=counts[0], visits=counts[1])
        notes.append(f"{k} on the flagship's bounce rays: a call {call_ms:.4f} ms (events), plain "
                     f"{plain_ms:.1f} ms, bit for bit, {counts[0] / n:.1f} tests a ray, bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")
    return out, notes


def _vs_loop(img_u, img_l, g_u, g_l):
    """The unfused walk's image and gradient against the loop route's ->
    their differences' statistics."""
    diff = (img_u - img_l).abs()[..., :3]
    over = diff > GOLDEN_ATOL + GOLDEN_RTOL * img_l[..., :3].abs()
    sums = g_u.double().sum((0, 1))
    want = g_l.double().sum((0, 1))
    mag = g_l.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    rel = (g_u - g_l).abs().amax(-1)[big] / mag[big]
    return {"image_max_abs": float(diff.max()), "image_mean_abs": float(diff.mean()),
            "image_over_golden_bar": int(over.sum()), "image_values": over.numel(),
            "grad_sums_rel": [float(x) for x in ((sums - want).abs() / want.abs()).tolist()],
            "grad_texels": int(big.sum()), "grad_worst_texel": float(rel.max()),
            "grad_texels_past_1e-4": int((rel > 1e-4).sum()),
            "grad_texels_past_1e-3": int((rel > 1e-3).sum())}


def _unfused_check(scene, mat, what):
    """The unfused walk with the trace kernels against the same walk with
    the plain traces, at UNFUSED_CHECK_RES, UNFUSED_CHECK_SPP: the image bit
    for bit, the gradient at phase 7's bars -> its note."""
    from zdr_tpu_torch import kernels

    t0 = time.perf_counter()
    res, spp = UNFUSED_CHECK_RES, UNFUSED_CHECK_SPP
    launches0 = kernels.trace_closest.launches + kernels.trace_any.launches
    img_k, g_k = _render_grad(scene, mat, res, spp, seed=3)
    if kernels.trace_closest.launches + kernels.trace_any.launches == launches0:
        raise AssertionError(f"phase 21 {what}: the trace kernels were not launched")
    with _CountPlainTraces() as plain, _PlainTraces():
        img_p, g_p = _render_grad(scene, mat, res, spp, seed=3)
    if plain.calls == 0:
        raise AssertionError(f"phase 21 {what}: the plain traces were not called")
    if not torch.equal(img_k, img_p):
        raise AssertionError(f"phase 21 {what}: {int((img_k != img_p).sum())} image values "
                             "differ from the walk with the plain traces")
    _err, worst = _assert_grad_close(g_k, g_p, f"phase 21 {what}")
    return (f"{what}: image bit for bit, gradient worst texel {worst:.2e} "
            f"({time.perf_counter() - t0:.1f} s)")


def phase_unfused(dev, smi):
    """Phase 21: the JAX package's unfused estimators, plain torch around
    the trace_closest and trace_any kernels -> the trace kernels' main-path
    launches and per-launch times, and the drives' numbers."""
    t0 = time.perf_counter()
    notes, out, secs = [], {}, {}
    res, spp = RES, UNFUSED_SPP
    # drive 1: the flagship with scene.fused = False (the persistent PRB walk)
    scene = _flagship(dev)
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()
    scene.fused = False
    with _CountPlainTraces() as plain:
        (img_u, g_u), counts = _drive_main(lambda: _render_grad(scene, mat, res, spp))
    if plain.calls:
        raise AssertionError("phase 21: the unfused flagship called a plain trace")
    if counts["trace_closest"] == 0 or counts["trace_any"] == 0:
        raise AssertionError(f"phase 21: the trace kernels were not launched: {counts}")
    others = {k: v for k, v in counts.items() if v and k not in TRACES}
    if others:
        raise AssertionError(f"phase 21: the unfused flagship launched {others}")
    if not bool(torch.isfinite(img_u).all()) or float(g_u.abs().sum()) == 0.0:
        raise AssertionError("phase 21: the unfused flagship's image or gradient is bad")
    scene.fused = "auto"
    (img_l, g_l), loop_counts = _drive_main(lambda: _render_grad(scene, mat, res, spp))
    if loop_counts["path_loop"] != 1 or loop_counts["path_loop_grad"] != 1:
        raise AssertionError(f"phase 21: the loop route's launches {loop_counts}")
    vs_loop = _vs_loop(img_u, img_l, g_u, g_l)
    if vs_loop["image_over_golden_bar"] > LOOP_VALUE_SHARE * vs_loop["image_values"] or \
            vs_loop["image_mean_abs"] > LOOP_MEAN_ABS or max(vs_loop["grad_sums_rel"]) > 1e-5 \
            or vs_loop["grad_texels_past_1e-4"] > LOOP_TEXEL_SHARE * vs_loop["grad_texels"]:
        raise AssertionError(f"phase 21: the unfused flagship against the loop route: {vs_loop}")
    scene.fused = False
    it_ms, it_runs = _times_ms(lambda: _render_grad(scene, mat, res, spp))
    fwd_ms, fwd_runs = _times_ms(lambda: scene.render(mat.detach(), res=res, spp=spp, seed=0))
    with _TraceCapture() as cap:
        prof = _trace_profile(lambda: scene.render(mat.detach(), res=res, spp=spp, seed=0))
    records, rec_notes = _trace_records(cap.args, counts, prof)
    out["records"] = records
    out["flagship"] = {"spp": spp, "launches": {k: counts[k] for k in TRACES},
                       "iteration_ms": it_ms, "iteration_runs": it_runs, "forward_ms": fwd_ms,
                       "forward_runs": fwd_runs, "vs_loop": vs_loop,
                       "per_launch": {k: prof[k] for k in TRACES} if prof else None,
                       "forward_device_ms": prof["all_kernels_ms"] if prof else None}
    secs["flagship"] = time.perf_counter() - t0
    notes.append(
        f"flagship fused=False {res[0]}x{res[1]} {spp} spp: {counts['trace_closest']} closest + "
        f"{counts['trace_any']} any launches, no other kernel, no plain trace; against the loop "
        f"route {vs_loop}; iteration {it_ms:.1f} ms (runs {[round(x, 1) for x in it_runs]}), "
        f"forward {fwd_ms:.1f} ms; "
        + (", ".join(f"{k} {prof[k][0]} launches {prof[k][1]:.4f} ms a launch" for k in TRACES)
           + f", the forward's kernels {prof['all_kernels_ms']:.1f} ms of device time"
           if prof else "the profiler saw no device time"))
    notes += rec_notes

    # drive 2: the same flagship under nearest filtering
    t1 = time.perf_counter()
    scene.bilinear = False
    (img_n, g_n), n_counts = _drive_main(lambda: _render_grad(scene, mat, res, spp))
    if not bool(torch.isfinite(img_n).all()) or not bool(torch.isfinite(g_n).all()) \
            or float(g_n.abs().sum()) == 0.0:
        raise AssertionError("phase 21: the nearest flagship's image or gradient is bad")
    n_ms, n_runs = _times_ms(lambda: _render_grad(scene, mat, res, spp))
    out["nearest"] = {"spp": spp, "launches": {k: n_counts[k] for k in TRACES},
                      "iteration_ms": n_ms, "iteration_runs": n_runs}
    secs["nearest"] = time.perf_counter() - t1
    notes.append(f"nearest: iteration {n_ms:.1f} ms, {n_counts['trace_closest']} + "
                 f"{n_counts['trace_any']} launches")

    # drive 3: direct without MIS on the cornell box (dense) and on the
    # protocol's 962 triangles by accel="auto" (the BVH)
    scenes = {"direct_cbox": _flagship(dev, "direct"),
              "direct_protocol_auto": _protocol(dev, accel="auto")}
    for key, sc in scenes.items():
        t1 = time.perf_counter()
        sc.use_mis = False
        (img_d, g_d), d_counts = _drive_main(lambda: _render_grad(sc, mat, res, spp))
        if d_counts["trace_closest"] == 0 or d_counts["trace_any"] == 0 or any(
                v for k, v in d_counts.items() if k not in TRACES):
            raise AssertionError(f"phase 21 {key}: launches {d_counts}")
        if not bool(torch.isfinite(img_d).all()) or float(g_d.abs().sum()) == 0.0:
            raise AssertionError(f"phase 21 {key}: bad image or gradient")
        d_ms, d_runs = _times_ms(lambda: _render_grad(sc, mat, res, spp))
        acc = sc._render_data("direct").accel
        route = "bvh" if acc is not None and acc.is_bvh else "dense"
        out[key] = {"spp": spp, "launches": {k: d_counts[k] for k in TRACES},
                    "iteration_ms": d_ms, "iteration_runs": d_runs, "route": route}
        secs[key] = time.perf_counter() - t1
        notes.append(f"{key} use_mis=False ({route}): iteration {d_ms:.1f} ms, "
                     f"{d_counts['trace_closest']} + {d_counts['trace_any']} launches")

    # the checks: each drive with the kernels against the plain traces
    t1 = time.perf_counter()
    small = torch.rand((64, 64, 4), generator=torch.Generator().manual_seed(5)).to(dev)
    small = (0.25 + 0.5 * small).requires_grad_()
    checks = []
    scene.bilinear = True
    checks.append(_unfused_check(scene, small, "flagship fused=False"))
    scene.bilinear = False
    checks.append(_unfused_check(scene, small, "flagship nearest"))
    for key, sc in scenes.items():
        checks.append(_unfused_check(sc, small, f"{key} use_mis=False"))
    coll = _golden_sphere(dev, "collocated", "auto")
    coll.bilinear = False
    checks.append(_unfused_check(coll, small, "collocated golden sphere nearest"))
    out["checks"] = checks
    secs["checks"] = time.perf_counter() - t1
    out["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    print(f"[21 unfused] " + "; ".join(notes) + f"; at {UNFUSED_CHECK_RES[0]}x"
          f"{UNFUSED_CHECK_RES[1]}, {UNFUSED_CHECK_SPP} spp against the plain traces: "
          + "; ".join(checks) + f"; seconds {out['seconds']}, "
          f"{time.perf_counter() - t0:.1f} s in all; card {smi}", flush=True)
    return out


# phase 22: the texture-recovery apps (zdr_tpu_torch/apps/) through their
# main(argv) on the card, at their full sizes (the apps' FULL). The
# example's iterations are cut from 500 to APP_EXAMPLE_ITERS and the
# lightstage's from 200 to one step a pattern; fd_validate runs its whole
# protocol (96x96, 48^2, spp 1 .. 2^APP_FD_MAX_EXP)
APP_EXAMPLE_ITERS = 10
APP_FD_MAX_EXP = 8
# the steps after which the example's checkpoint is saved
APP_CHECKPOINT_STEP = 2


def _steps(path):
    """A RunLogger jsonl's records."""
    with open(path) as f:
        return [json.loads(line) for line in f]


def _app_run(what, fn, expect):
    """One app's main(argv) as a main-path call: its launch counts must be
    `expect` (kernel -> count) and no other kernel's, no plain version (the
    integrators' or the traces') called -> (its result, its seconds)."""
    plain = _plain_calls()
    with _CountPlainTraces() as plain_traces:
        (out, ms), counts = _drive_main(lambda: _sync_ms(fn))
    got = {k: v for k, v in counts.items() if v}
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect}")
    if _plain_calls() != plain or plain_traces.calls:
        raise AssertionError(f"{what}: the app ran a plain version")
    return out, ms / 1e3


def _duvdxy_check(scene, mat, res, spp):
    """render_duvdxy on the example's scene at its size: one trace_closest
    launch a sample, the kernel bit for bit its plain version
    (trace_closest_plain) on the render's own rays at every CHECK_STRIDE-th
    ray of every sample; its time (median of 3) and a launch's alone ->
    (the trace record's numbers, a note)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.accel.trace import trace_closest_plain
    from zdr_tpu_torch.camera import camera_const
    from zdr_tpu_torch.integrators import uvgrad
    from zdr_tpu_torch.integrators.wrapper import pixel_grid, with_accel

    dev = scene.device
    aov, counts = _drive_main(lambda: scene.render_duvdxy(mat, res=res, spp=spp))
    if {k: v for k, v in counts.items() if v} != {"trace_closest": spp}:
        raise AssertionError(f"render_duvdxy: launches {counts}")
    if tuple(aov.shape) != (res[1], res[0], 4) or not bool(torch.isfinite(aov).all()):
        raise AssertionError("render_duvdxy: the AOV is not finite (H, W, 4)")
    data = with_accel(scene._render_data(scene.integrator))
    cfg = scene._config(res, spp)
    cam, coords = camera_const(scene.camera).to(dev), pixel_grid(res, dev)
    consts = uvgrad.ray_consts(res, dev)
    rays = [uvgrad.sample_rays(cam, consts, coords, 0, cfg, it)[0] for it in range(spp)]
    plain_ms = 0.0
    for o, d in rays:
        got = kernels.trace_closest(data.accel, o, d)
        (want, _work), ms = _sync_ms(lambda: trace_closest_plain(
            data.accel, o[::CHECK_STRIDE], d[::CHECK_STRIDE], 0.0, 1e30))
        plain_ms += ms
        for g, w in zip(got, want):
            if not torch.equal(g[::CHECK_STRIDE], w):
                raise AssertionError("render_duvdxy: trace_closest differs from its plain "
                                     "version on the render's rays")
    render_ms, runs = _median_ms(
        lambda: scene.render_duvdxy(mat, res=res, spp=spp), reps=3)
    # the card's busy time in one render, and a trace launch's, by the profiler
    prof = _trace_profile(lambda: scene.render_duvdxy(mat, res=res, spp=spp)) or {}
    busy_ms = prof.get("all_kernels_ms")
    trace_dev_ms = prof.get("trace_closest", (0, None))[1]
    o, d = rays[0]
    launch_ms, _r = _event_ms(lambda: kernels.trace_closest(data.accel, o, d), reps=5)
    tests, visits = kernels.trace_closest.counts.tolist()
    bound = _bound(tests, _trace_nbytes("trace_closest", data.accel, o, d), visits)
    hits = int((aov[..., 0] != 0).sum())
    rec = dict(launches=spp, ms=launch_ms, plain_ms=plain_ms / spp,
               plain_shape=f"every {CHECK_STRIDE}th ray of a sample's {res[0]}x{res[1]}",
               bound_ms=bound[0], bound_by=bound[1], tests=tests, visits=visits,
               render_duvdxy_ms=render_ms, render_busy_ms=busy_ms,
               per_launch_ms_in_render=trace_dev_ms, max_abs_err=0.0)
    note = (f"render_duvdxy {res[0]}x{res[1]} {spp} spp: {spp} trace_closest "
            f"launches ({'BVH' if data.accel.is_bvh else 'dense'}), no other kernel, "
            f"{hits} pixels with a footprint; the kernel equals its plain version bit for bit "
            f"on every {CHECK_STRIDE}th ray of all {spp} samples; median "
            f"{render_ms:.2f} ms of {[round(t, 2) for t in runs]} (the card busy "
            f"{busy_ms} ms of one, a trace launch {trace_dev_ms} ms there), a launch alone "
            f"{launch_ms:.3f} ms ({tests / o.shape[0]:.2f} tests and {visits / o.shape[0]:.2f} "
            f"visits a ray) -> bound {bound[0]:.4f} ms ({bound[1]})")
    return rec, note


def _checkpoint_check(scene, dev):
    """The example's recovery for APP_CHECKPOINT_STEP steps at full size,
    saved, loaded into a fresh Adam on the card: every tensor bit-equal,
    and one more step from each on the same gradient bit-equal; an Adam
    step's time alone -> (its ms, a note)."""
    import tempfile

    from zdr_tpu_torch.apps import example
    from zdr_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    res, tex, _spp_gt, spp, _iters = example.FULL
    with torch.no_grad():
        target = scene.render(example.procedural_wood(tex, dev), res=res, spp=spp)
    mat = torch.full((tex, tex, 4), 0.5, device=dev).requires_grad_()
    opt = torch.optim.Adam([mat], lr=example.LR)
    for it in range(APP_CHECKPOINT_STEP):
        example.train_step(scene, mat, opt, target, res, spp, it + 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(path, mat, opt, APP_CHECKPOINT_STEP)
        mat2 = torch.empty((tex, tex, 4), device=dev).requires_grad_()
        opt2 = torch.optim.Adam([mat2], lr=example.LR)
        _m, step, _x = load_checkpoint(path, opt2)
    st, st2 = opt.state[mat], opt2.state[mat2]
    if not (step == APP_CHECKPOINT_STEP and torch.equal(mat, mat2)
            and all(torch.equal(st[k], st2[k]) for k in ("step", "exp_avg", "exp_avg_sq"))):
        raise AssertionError("checkpoint: the loaded state differs from the saved one")
    # one more step from each on the same gradient
    m = mat.detach().clone().requires_grad_()
    ((scene.render(m, res=res, spp=spp, seed=APP_CHECKPOINT_STEP + 1) - target) ** 2
     ).sum().backward()
    for p, o in ((mat, opt), (mat2, opt2)):
        p.grad = m.grad.clone()
        o.step()
        with torch.no_grad():
            p.clamp_(*example.CLAMP)
    if not (torch.equal(mat, mat2) and all(torch.equal(opt.state[mat][k], opt2.state[mat2][k])
                                           for k in ("exp_avg", "exp_avg_sq"))):
        raise AssertionError("checkpoint: the step after the load differs")
    adam_ms, _r = _event_ms(opt.step, reps=5)
    return adam_ms, (f"checkpoint after step {APP_CHECKPOINT_STEP} of the example at "
                     f"{res[0]}x{res[1]}, {tex}^2: loaded into a fresh Adam on the card bit for "
                     f"bit, the next step from each bit-equal; an Adam step on {tex * tex * 4} "
                     f"floats {adam_ms:.3f} ms (CUDA events)")


def phase_apps(dev, smi):
    """Phase 22: the texture-recovery apps through their main(argv) on the
    card -> the apps' numbers, by kernel."""
    import tempfile

    from zdr_tpu_torch.apps import example, fd_validate, lightstage
    from zdr_tpu_torch.imageio_exr import load_exr
    from zdr_tpu_torch.integrators import path_loop as pl

    out = {}
    res, tex, spp_gt, spp, _iters = example.FULL
    duv_spp = max(spp // 4, 1)
    with tempfile.TemporaryDirectory() as tmp:
        # the example (512^2, a 512^2 material, GT 512 spp, 64 spp a step),
        # APP_EXAMPLE_ITERS steps: GT and the final render launch
        # direct_env_bvh, each step direct_env_bvh and direct_grad_env_bvh,
        # render_duvdxy trace_closest a sample
        log = os.path.join(tmp, "example.jsonl")
        n = APP_EXAMPLE_ITERS
        ex_launches = {"direct_env_bvh": n + 2, "direct_grad_env_bvh": n,
                       "trace_closest": duv_spp}
        mse, secs = _app_run("example", lambda: example.main(
            ["--iters", str(n), "--out", tmp, "--log", log, "--device", str(dev)]), ex_launches)
        steps = _steps(log)
        losses = [r["loss"] for r in steps]
        if not (len(steps) == n and math.isfinite(mse) and losses[-1] < losses[0]):
            raise AssertionError(f"example: {len(steps)} steps, mse {mse}, losses {losses}")
        for name in example.OUTPUTS:
            img = load_exr(os.path.join(tmp, f"{name}.exr"))
            if img.shape[2] != 3 or not np.isfinite(img).all():
                raise AssertionError(f"example: {name}.exr reads back as {img.shape}")
            if not os.path.getsize(os.path.join(tmp, f"{name}.png")):
                raise AssertionError(f"example: {name}.png is empty")
        ex_ms = statistics.median(r["step_ms"] for r in steps[1:])
        out["example"] = dict(launches=ex_launches,
                              step_ms=ex_ms, first_step_ms=steps[0]["step_ms"], seconds=secs,
                              mse=mse, loss_first=losses[0], loss_last=losses[-1])
        print(f"[22 apps] example ({res[0]}x{res[1]}, {tex}^2 material, GT {spp_gt} spp, {spp} "
              f"spp a step, {n} of 500 iterations) through main(argv): {n + 2} direct_env_bvh, "
              f"{n} direct_grad_env_bvh, {duv_spp} trace_closest launches, no other kernel, no "
              f"plain version; loss {losses[0]:.2f} -> {losses[-1]:.2f}, final MSE {mse:.6f}; "
              f"the five EXRs read back by load_exr; step median {ex_ms:.2f} ms of "
              f"{[round(r['step_ms'], 2) for r in steps]}; {secs:.1f} s in all; card {smi}",
              flush=True)
        # the lightstage (30 lights, 512^2, 256 spp, 8 patterns), one step
        # a pattern: GT, each step and the noise floor launch direct_bvh,
        # each step direct_grad_bvh
        log = os.path.join(tmp, "lightstage.jsonl")
        n_lights, ls_res, ls_spp, _iters, ls_tex, n_pat = lightstage.FULL
        k = n_pat
        ls_launches = {"direct_bvh": 2 * n_pat + k, "direct_grad_bvh": k}
        r, secs = _app_run("lightstage", lambda: lightstage.main(
            ["--iters", str(k), "--log", log, "--device", str(dev)]), ls_launches)
        steps = _steps(log)
        if len(steps) != k or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"lightstage: {len(steps)} steps, {r}")
        ls_ms = statistics.median(s["step_ms"] for s in steps[1:])
        out["lightstage"] = dict(launches=ls_launches,
                                 step_ms=ls_ms, first_step_ms=steps[0]["step_ms"],
                                 seconds=secs, **r)
        print(f"[22 apps] lightstage ({n_lights} lights, {ls_res[0]}x{ls_res[1]}, {ls_spp} spp, "
              f"{n_pat} patterns, {k} of 200 steps) through main(argv): {2 * n_pat + k} direct_bvh, {k} direct_grad_bvh "
              f"launches, no "
              f"other kernel, no plain version; loss {r['loss_first']:.2f} -> "
              f"{r['loss_last']:.2f}, noise floor {r['noise_floor']:.2f}; step median "
              f"{ls_ms:.2f} ms of {[round(s['step_ms'], 2) for s in steps]}; {secs:.1f} s in "
              f"all", flush=True)
        # fd_validate: the pick's 2 renders and gradient at 64 spp, then the
        # FD (2 renders) and AD (a render and its backward) rows
        e = APP_FD_MAX_EXP + 1
        fd, secs = _app_run("fd_validate", lambda: fd_validate.main(
            ["--max-exp", str(APP_FD_MAX_EXP), "--device", str(dev)]),
            {"path_loop": 3 + 15 * e, "path_loop_grad": 1 + 5 * e})
        if not all(math.isfinite(v) for row in fd["fd"] + fd["ad"] for v in row):
            raise AssertionError("fd_validate: a non-finite row")
        fd_mean, ad_mean = (float(np.mean(fd[key][-1])) for key in ("fd", "ad"))
        out["fd_validate"] = dict(launches={"path_loop": 3 + 15 * e, "path_loop_grad": 1 + 5 * e},
                                  seconds=secs, imgidx=fd["imgidx"], texidx=fd["texidx"],
                                  fd_last=fd["fd"][-1], ad_last=fd["ad"][-1])
        print(f"[22 apps] fd_validate (path, 96x96, 48^2, spp 1 .. {2 ** APP_FD_MAX_EXP}, 5 "
              f"seeds) through main(argv): {3 + 15 * e} path_loop, {1 + 5 * e} path_loop_grad "
              f"launches, no other kernel, no plain version; pixel {fd['imgidx']}, texel "
              f"{fd['texidx']}; at {2 ** APP_FD_MAX_EXP} spp FD mean {fd_mean:.6f}, AD mean "
              f"{ad_mean:.6f}; {secs:.1f} s in all", flush=True)

    # one lightstage pattern's kernels against their plain versions on its
    # own inputs (the first pattern after update_lights, the first step's
    # seed, the GT material), at every CHECK_STRIDE-th lane, the first
    # CHECK_SAMPLES samples, the forward bit for bit
    scene = lightstage.build_lightstage(n_lights, device=dev)
    scene.camera = lightstage.make_camera()
    scene.update_lights(lightstage.make_patterns(n_lights, n_pat)[0])
    data = scene._render_data("direct")
    cfg = scene._config(ls_res, ls_spp)
    mat = torch.as_tensor(np.random.RandomState(5).uniform(0.2, 0.8, (ls_tex, ls_tex, 4))
                          .astype(np.float32), device=dev)
    err, g_err, plain_ms, gplain_ms, note = _bvh_check(
        pl.build_loop_tables(data, scene.camera, cfg, 100),
        pl.build_loop_tables(data, scene.camera, cfg, 101), mat, "direct",
        "lightstage pattern 0", exact=True)
    out["lightstage"].update(max_abs_err=err, g_max_abs_err=g_err, plain_ms=plain_ms,
                             gplain_ms=gplain_ms)
    print(f"[22 apps] lightstage pattern 0 ({data.meta.n_lights} lights on of {n_lights}, "
          f"{data.meta.num_tris} tris, BVH): direct_bvh and direct_grad_bvh {note}", flush=True)

    ex_scene = example.build_scene(device=dev)
    duv, note = _duvdxy_check(ex_scene, example.procedural_wood(tex, dev), res, duv_spp)
    out["render_duvdxy"] = duv
    print(f"[22 apps] {note}", flush=True)
    adam_ms, note = _checkpoint_check(ex_scene, dev)
    out["adam_ms"] = adam_ms
    print(f"[22 apps] {note}", flush=True)
    print(f"[22 apps] medians: example step {out['example']['step_ms']:.2f} ms, lightstage step "
          f"{out['lightstage']['step_ms']:.2f} ms, render_duvdxy {duv['render_duvdxy_ms']:.2f} "
          f"ms, Adam step {adam_ms:.3f} ms; card {smi}", flush=True)
    return out


# phase 23: the ranks on the one card (gloo), the seconds a spawn may take,
# the lightstage's batched steps, and the batch check's size
PAR_RANKS = 2
PAR_TIMEOUT = 600
PAR_LS_ITERS = 3
PAR_BATCH_RES, PAR_BATCH_SPP = (128, 128), 8


def _rank_launches(what, results, job, expect):
    """Every rank's launches of one job: exactly `expect` (kernel -> count a
    rank) and no other kernel."""
    for r, res in enumerate(results):
        got = {k: v for k, v in res[job]["launches"].items() if v}
        if got != expect:
            raise AssertionError(f"{what}: rank {r} launched {got}, expected {expect}")


def _sharded_check(what, results, img, grad):
    """Every rank's render_sharded image bit for bit the single-device
    image, its gradient at phase 7's bars -> (max abs error, worst rel)."""
    err = (0.0, 0.0)
    for r, res in enumerate(results):
        if not np.array_equal(res[0]["image"], img.cpu().numpy()):
            raise AssertionError(f"{what}: rank {r}'s image differs from Scene.render's")
        e = _assert_grad_close(torch.as_tensor(res[0]["grad"]), grad.cpu(), f"{what} rank {r}")
        err = max(err, e)
    return err


def phase_parallel(dev, smi):
    """Phase 23: parallel.py on the card. The flagship (512x512, 64 spp,
    1024^2 material of 0.5) through render_sharded + loss.backward() on
    PAR_RANKS gloo ranks on cuda:0, then on NCCL with one rank a card: each
    rank one path_loop and one path_loop_grad launch on its 131,072 lanes,
    the image bit for bit the single-device Scene.render's, the gradient at
    phase 7's bars; render_batch of 8 epsilon-off lightstage patterns (30
    lights) at 128x128, 8 spp on the gloo ranks, every view bit for bit the
    sequential update_lights + Scene.render at its seed, the gradient at
    phase 7's bars against the sum of the views'; dryrun_multichip; then the
    lightstage's main(["--batched", ...]) at full size in this process (one
    rank), PAR_LS_ITERS steps, and at --small (--iters 10 --tex 8) held to
    tests/test_apps.py's batched recovery gate -> the phase's numbers."""
    from zdr_tpu_torch import parallel as par
    from zdr_tpu_torch.apps import lightstage

    out = {}
    spec = par.flagship_spec()
    scene = spec.build(dev)
    mat0 = np.full((TEX, TEX, 4), 0.5, np.float32)
    mat = torch.as_tensor(mat0, device=dev).requires_grad_()
    img, grad = _render_grad(scene, mat, RES, SPP)
    single_ms, _r = _median_ms(lambda: _render_grad(scene, mat, RES, SPP), reps=3)
    n_lights, ls_res, ls_spp, _iters, ls_tex, n_pat = lightstage.FULL
    ls_spec = par.SceneSpec(models=lightstage.lightstage_models(n_lights), integrator="direct",
                            camera=lightstage.make_camera())
    patterns = lightstage.make_patterns(n_lights, n_pat, lightstage.OFF_BATCHED)
    ls_mat = np.random.RandomState(5).uniform(0.2, 0.8, (ls_tex, ls_tex, 4)).astype(np.float32)
    lanes = RES[0] * RES[1] // PAR_RANKS
    flag = (par.sharded_iteration, dict(spec=spec, material=mat0, res=RES, spp=SPP, seed=0,
                                        reps=3, mesh=True))
    jobs = [flag,
            (par.batch_iteration, dict(spec=ls_spec, material=ls_mat, patterns=patterns,
                                       res=PAR_BATCH_RES, spp=PAR_BATCH_SPP, seed=0)),
            (par.dryrun_multichip, {})]
    t0 = time.perf_counter()
    gloo = par.launch(jobs, PAR_RANKS, backend="gloo", devices=str(dev), timeout=PAR_TIMEOUT)
    gloo_s = time.perf_counter() - t0
    _rank_launches("gloo flagship", gloo, 0, {"path_loop": 1, "path_loop_grad": 1})
    err, worst = _sharded_check("gloo flagship", gloo, img, grad)
    ms = [statistics.median(r[0]["ms"]) for r in gloo]
    out["gloo"] = dict(ranks=PAR_RANKS, lanes_a_rank=lanes, iteration_ms=ms,
                       max_abs_err=err, worst_rel=worst, seconds=gloo_s)
    print(f"[23 parallel] flagship ({RES[0]}x{RES[1]}, {SPP} spp, {TEX}^2 material) through "
          f"render_sharded + loss.backward() on {PAR_RANKS} gloo ranks on {dev} (a make_mesh "
          f"mesh): each rank 1 path_loop and 1 path_loop_grad launch on {lanes} lanes, no "
          f"other kernel; the image equals the single-device Scene.render's bit for bit on "
          f"every rank, the gradient at phase 7's bars (max abs err {err:.3e}, worst texel rel "
          f"{worst:.3e}); iteration median by rank {[round(m, 2) for m in ms]} ms (each of 3 "
          f"after a barrier) against {single_ms:.2f} ms on one rank; the spawn {gloo_s:.1f} s "
          f"in all; card {smi}", flush=True)

    # the batch: each view against the sequential renders at its seed
    seq = lightstage.build_lightstage(n_lights, device=dev)
    seq.camera = lightstage.make_camera()
    views, seq_grad = [], None
    for p, em in enumerate(patterns):
        seq.update_lights(em)
        m = torch.as_tensor(ls_mat, device=dev).requires_grad_()
        v, g = _render_grad(seq, m, PAR_BATCH_RES, PAR_BATCH_SPP, seed=7919 * p)
        views.append(v.cpu().numpy())
        seq_grad = g if seq_grad is None else seq_grad + g
    n_local = n_pat // PAR_RANKS
    _rank_launches("gloo batch", gloo, 1, {"direct_bvh": n_local, "direct_grad_bvh": n_local})
    b_err = (0.0, 0.0)
    for r, res in enumerate(gloo):
        if not np.array_equal(res[1]["images"], np.stack(views)):
            raise AssertionError(f"render_batch: rank {r}'s views differ from the sequential "
                                 f"renders")
        b_err = max(b_err, _assert_grad_close(torch.as_tensor(res[1]["grad"]), seq_grad.cpu(),
                                              f"render_batch rank {r}"))
    losses = gloo[0][2]
    if any(r[2] != losses for r in gloo) or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dryrun_multichip: losses by rank {[r[2] for r in gloo]}")
    out["batch"] = dict(views=n_pat, views_a_rank=n_local, max_abs_err=b_err[0],
                        worst_rel=b_err[1])
    out["dryrun"] = dict(loss=losses[0], batched_loss=losses[1])
    print(f"[23 parallel] render_batch of {n_pat} epsilon-off lightstage patterns ({n_lights} "
          f"lights, {PAR_BATCH_RES[0]}x{PAR_BATCH_RES[1]}, {PAR_BATCH_SPP} spp) on "
          f"{PAR_RANKS} gloo ranks: each rank {n_local} direct_bvh and {n_local} "
          f"direct_grad_bvh launches, every view equal bit for bit to update_lights + "
          f"Scene.render at seed 7919 p, the gradient at phase 7's bars against the sum of the "
          f"views' (max abs err {b_err[0]:.3e}); dryrun_multichip({PAR_RANKS}): loss {losses[0]:.6f}, batched {PAR_RANKS}-view loss "
          f"{losses[1]:.6f}", flush=True)

    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    nccl = par.launch([flag], n_cards, backend="nccl",
                      devices=[f"cuda:{r}" for r in range(n_cards)], timeout=PAR_TIMEOUT)
    nccl_s = time.perf_counter() - t0
    n_lanes = RES[0] * RES[1] // n_cards
    _rank_launches("nccl flagship", nccl, 0, {"path_loop": 1, "path_loop_grad": 1})
    n_err, n_worst = _sharded_check("nccl flagship", nccl, img, grad)
    n_ms = [statistics.median(r[0]["ms"]) for r in nccl]
    out["nccl"] = dict(ranks=n_cards, lanes_a_rank=n_lanes, iteration_ms=n_ms,
                       max_abs_err=n_err, worst_rel=n_worst, seconds=nccl_s)
    print(f"[23 parallel] the same on NCCL, {n_cards} rank(s), one a card: each rank 1 "
          f"path_loop and 1 path_loop_grad launch on {n_lanes} lanes, the image bit for bit, "
          f"the gradient at phase 7's bars (max abs err {n_err:.3e}); iteration median by rank "
          f"{[round(m, 2) for m in n_ms]} ms; the spawn {nccl_s:.1f} s in all", flush=True)

    # the lightstage's --batched at full size, one rank: the targets, each
    # step and the noise floor render every pattern (direct_bvh), each step
    # differentiates every pattern (direct_grad_bvh)
    import tempfile

    k = PAR_LS_ITERS
    expect = {"direct_bvh": n_pat * (k + 2), "direct_grad_bvh": n_pat * k}
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "lightstage.jsonl")
        r, secs = _app_run("lightstage --batched", lambda: lightstage.main(
            ["--batched", "--iters", str(k), "--log", log, "--device", str(dev)]), expect)
        steps = _steps(log)
    if len(steps) != k or not all(math.isfinite(v) for v in r.values()):
        raise AssertionError(f"lightstage --batched: {len(steps)} steps, {r}")
    step_ms = statistics.median(x["step_ms"] for x in steps[1:])
    out["lightstage"] = dict(launches=expect, step_ms=step_ms, first_step_ms=steps[0]["step_ms"],
                             seconds=secs, **r)
    print(f"[23 parallel] lightstage --batched ({n_lights} lights, {ls_res[0]}x{ls_res[1]}, "
          f"{ls_spp} spp, {n_pat} patterns a step, {k} steps) through main(argv) on one rank: "
          f"{expect['direct_bvh']} direct_bvh, {expect['direct_grad_bvh']} direct_grad_bvh "
          f"launches, no other kernel, no plain version; loss {r['loss_first']:.2f} -> "
          f"{r['loss_last']:.2f}, noise floor {r['noise_floor']:.2f}; step median "
          f"{step_ms:.2f} ms of {[round(x['step_ms'], 2) for x in steps]}; {secs:.1f} s in "
          f"all; card {smi}", flush=True)

    # the batched recovery gate of tests/test_apps.py at its own --small
    # sizes (10 lights, 48x48, 16 spp, 4 patterns; --iters 10 --tex 8)
    n_small = lightstage.SMALL[5]
    expect = {"direct_bvh": n_small * 12, "direct_grad_bvh": n_small * 10}
    r, secs = _app_run("lightstage --small --batched", lambda: lightstage.main(
        ["--small", "--batched", "--iters", "10", "--tex", "8", "--device", str(dev)]), expect)
    gate = (r["tex_err_diffuse"] < 0.985 * r["tex_err0_diffuse"],
            r["loss_last"] < 0.97 * r["loss_first"], r["loss_last"] < 1.5 * r["noise_floor"])
    if not all(gate):
        raise AssertionError(f"lightstage --small --batched: the recovery gate {gate}: {r}")
    out["lightstage_small"] = dict(launches=expect, seconds=secs, **r)
    print(f"[23 parallel] lightstage --small --batched --iters 10 --tex 8 on one rank: the "
          f"recovery gate of tests/test_apps.py met: diffuse error {r['tex_err0_diffuse']:.4f} "
          f"-> {r['tex_err_diffuse']:.4f}, loss {r['loss_first']:.2f} -> {r['loss_last']:.2f}, "
          f"noise floor {r['noise_floor']:.2f}; {secs:.1f} s", flush=True)
    return out


# phase 24: the splat knobs (splat_merge, packed_splat) the flagship's
# iteration is timed at, in turns (A B B A ...), SPLAT_ROUNDS rounds of
# each; a merged gradient's texels that may differ from the plain
# version's by more than the bars, each where a merge chose the other tap
# (u tot < wp decided the other way by the float rounding in which the two
# differ), at most FLIP_SHARE of the texels it touches
SPLAT_KNOBS = ((1, False), (4, False), (1, True), (4, True))
SPLAT_ROUNDS = 4
FLIP_SHARE = 1e-3


def _bf16_ulp(x):
    """One bf16 ulp of each |x|: 2^(exponent - 7)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(tiny))) - 7)


def _assert_splat_close(got, want, what, packed, merged):
    """A gradient of the splat knobs against its plain version: the texels
    each touches equal (the selected taps' ids); the per-channel sums within
    rtol 1e-5; unpacked, every texel past 1e-3 of the largest within rtol
    1e-4 (phase 7's bars); packed, every texel within one bf16 ulp of the
    plain version's (the atomics' order, and the taps' float rounding, can
    take a total across a rounding boundary: those texels are counted as
    rounding flips). A merged gradient may break the texel bars at
    FLIP_SHARE of its touched texels (merge flips) -> a note's numbers."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite gradient")
    sums, want_sums = got.double().sum((0, 1)), want.double().sum((0, 1))
    if not bool(torch.allclose(sums, want_sums, rtol=1e-5, atol=0.0)):
        raise AssertionError(f"{what}: channel sums {sums.tolist()} vs plain {want_sums.tolist()}")
    touched, want_touched = got.abs().amax(-1) > 0, want.abs().amax(-1) > 0
    ids_differ = touched != want_touched
    mag = want.abs().amax(-1)
    if packed:
        bad = ((got - want).abs() > _bf16_ulp(torch.maximum(got.abs(), want.abs()))).any(-1)
        rounding = int(((got != want).any(-1) & ~bad).sum())
    else:
        big = mag > 1e-3 * float(mag.max())
        rel = (got - want).abs().amax(-1) / mag.clamp_min(1e-30)
        bad = big & (rel > 1e-4)
        rounding = 0
    flips = int((bad | ids_differ).sum())
    n = int((touched | want_touched).sum())
    allowed = int(FLIP_SHARE * n) if merged else 0
    if flips > allowed or (int(ids_differ.sum()) and not merged):
        raise AssertionError(f"{what}: {flips} of {n} texels past the bars ({int(ids_differ.sum())} "
                             f"touched by one side only; {allowed} allowed)")
    return dict(max_abs_err=float((got - want).abs().max()), texels=n, merge_flips=flips,
                ids_differ=int(ids_differ.sum()), rounding_flips=rounding)


def _knob_tables(scene, merge, packed, seed, res=RES, spp=SPP):
    from zdr_tpu_torch.integrators import path_loop as pl

    scene.splat_merge, scene.packed_splat = merge, packed
    return pl.build_loop_tables(scene._render_data(scene.integrator), scene.camera,
                                scene._config(res, spp), seed)


def _splat_drive(scene, merge, packed, tex, what, expect):
    """One main-path iteration of `scene` at the knobs: its launches must be
    `expect` (kernel: count) and none other, no plain version -> counts."""
    scene.splat_merge, scene.packed_splat = merge, packed
    mat = torch.full((tex, tex, 4), 0.5, dtype=torch.float32, device=scene.device)
    mat.requires_grad_()
    plain = _plain_calls()
    _loss, counts = _drive_main(_iteration(scene, mat, RES, SPP))
    torch.cuda.synchronize()
    got = {k: v for k, v in counts.items() if v}
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect}")
    if _plain_calls() != plain:
        raise AssertionError(f"{what}: the iteration ran a plain version")
    g = mat.grad
    if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        raise AssertionError(f"{what}: non-finite or zero gradient")
    return got


def phase_splat(dev, smi, ptxas, grad_run, big, coll, proto):
    """Phase 24 -> the splat knobs' numbers, by kernel."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import collocated as co
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.texture import round_bf16

    out, notes = {}, []
    n_grad = 4 * TEX * TEX
    # the flagship's main path at JAX's defaults: the merged gradient kernel
    # and its epilogue
    scene = _flagship(dev)
    counts = _splat_drive(scene, 4, True, TEX, "24 splat flagship (4, True)",
                          {"path_loop": 1, "path_loop_grad": 1, "splat_round": 1})
    mat = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev).requires_grad_()
    iteration = _iteration(scene, mat, RES, SPP)
    runs = {k: [] for k in SPLAT_KNOBS}
    for knobs in SPLAT_KNOBS:  # warm-up
        scene.splat_merge, scene.packed_splat = knobs
        iteration()
    for r in range(SPLAT_ROUNDS):
        for knobs in (SPLAT_KNOBS if r % 2 == 0 else SPLAT_KNOBS[::-1]):
            scene.splat_merge, scene.packed_splat = knobs
            runs[knobs].append(_sync_ms(iteration)[1])
    it_ms = {f"{m},{p}": statistics.median(v) for (m, p), v in runs.items()}
    notes.append("flagship iteration medians (ms, turns A B B A, "
                 f"{SPLAT_ROUNDS} a setting): " + ", ".join(
                     f"({m}, {p}) {statistics.median(v):.2f} of {[round(t, 2) for t in v]}"
                     for (m, p), v in runs.items()))

    # path_loop_grad at (4, False) and (4, True) against the plain backward
    # at every CHECK_STRIDE-th lane; each instantiation alone by events
    m = mat.detach()
    lanes = pl.pixel_lanes(RES, SPP, dev)
    sub = lanes[:, ::CHECK_STRIDE].contiguous()
    le_sub = torch.zeros((3, lanes.shape[1]), device=dev)
    le_sub[:, ::CHECK_STRIDE] = 1.0 / SPP
    le = torch.full((3, lanes.shape[1]), 1.0 / SPP, device=dev)
    path = {}
    # the plain backward at (4, True) is its (4, False) walk with the totals
    # rounded (scatter_add4(packed=True)): one plain walk checks both
    (want4, _c), plain_ms = _sync_ms(lambda: pl.render_path_backward_loop_plain(
        _knob_tables(scene, 4, False, 1), sub, m, le_sub[:, ::CHECK_STRIDE].contiguous(),
        _knob_tables(scene, 4, False, 1).n_steps))
    for merge, packed in ((4, False), (4, True), (1, True)):
        tb1 = _knob_tables(scene, merge, packed, 1)
        got, _c = kernels.path_loop_grad(tb1, lanes, m, le_sub, tb1.n_steps)
        rec = dict(launches=counts["path_loop_grad"] if (merge, packed) == (4, True) else None,
                   splat_merge=merge, packed_splat=packed)
        if merge > 1:
            want = round_bf16(want4) if packed else want4
            rec.update(_assert_splat_close(got, want, f"24 path_loop_grad ({merge}, {packed})",
                                           packed, True), plain_ms=plain_ms,
                       plain_shape=f"every {CHECK_STRIDE}th lane of {RES[0]}x{RES[1]}, {SPP} spp")
        rec["ms"], rec["runs"] = _event_ms(
            lambda: kernels.path_loop_grad(tb1, lanes, m, le, tb1.n_steps))
        rec.update(bound_ms=grad_run["bound_ms"], bound_by=grad_run["bound_by"],
                   library_ms=None, plan=dict(kernels.path_loop_grad.plan),
                   ptxas=ptxas["path_loop_grad_merge" if merge > 1 else "path_loop_grad"])
        path[f"{merge},{packed}"] = rec
    out["path_loop_grad"] = path
    notes.append(f"path_loop_grad vs plain at every {CHECK_STRIDE}th lane: " + "; ".join(
        f"({k}) texels {r['texels']}, merge flips {r['merge_flips']}, rounding flips "
        f"{r['rounding_flips']}, max abs diff {r['max_abs_err']:.3e}, kernel {r['ms']:.2f} ms"
        for k, r in path.items() if "texels" in r)
        + f"; (1, True) kernel {path['1,True']['ms']:.2f} ms; merged launch "
        + _plan_note(path["4,True"]["plan"]))

    # splat_round: the epilogue alone, its plain version, the library call
    g = torch.randn((TEX, TEX, 4), device=dev) * 1e-3
    want = round_bf16(g)
    got = kernels.splat_round(g.clone())
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("24 splat_round: in place, not bit for bit the plain version")
    scratch, acc0 = g.clone(), torch.randn_like(g)
    got = kernels.splat_round(acc0.clone(), scratch)
    if not (torch.equal(got, acc0 + want) and not bool(scratch.any())):
        raise AssertionError("24 splat_round: the round-add differs from grad + bf16(scratch)")
    work = g.clone()
    sr_ms, _r = _event_ms(lambda: kernels.splat_round(work))
    _p, sr_plain_ms = _sync_ms(lambda: round_bf16(g))
    lib_ms, _r = _event_ms(lambda: g.to(torch.bfloat16).float())
    sr_bound = _bound(0, 2 * 4 * n_grad)
    out["splat_round"] = dict(
        launches=counts["splat_round"], max_abs_err=0.0, ms=sr_ms, plain_ms=sr_plain_ms,
        plain_shape=f"{TEX}^2 x 4", bound_ms=sr_bound[0], bound_by=sr_bound[1],
        library_ms=lib_ms)
    notes.append(f"splat_round in place bit for bit round_bf16, round-add exact: {sr_ms:.4f} ms "
                 f"(bound {sr_bound[0]:.4f} ms, bytes), plain {sr_plain_ms:.3f} ms, "
                 f"x.to(torch.bfloat16).float() {lib_ms:.4f} ms")

    # direct_grad on the cornell box, packed, against its plain version
    dscene = _flagship(dev, "direct")
    dcounts = _splat_drive(dscene, 1, True, TEX, "24 splat direct",
                           {"direct": 1, "direct_grad": SPP // 4, "splat_round": SPP // 4})
    tb1 = _knob_tables(dscene, 1, True, 1)
    got, _acc = kernels.direct_grad(tb1, lanes, m, le_sub)
    (want, _acc), plain_ms = _sync_ms(lambda: dr.render_direct_backward_plain(
        tb1, sub, m, le_sub[:, ::CHECK_STRIDE].contiguous()))
    rec = _assert_splat_close(got, want, "24 direct_grad packed", True, False)
    rec["ms"], rec["runs"] = _event_ms(lambda: kernels.direct_grad(tb1, lanes, m, le))
    tb_exact = _knob_tables(dscene, 1, False, 1)
    exact_ms, _r = _event_ms(lambda: kernels.direct_grad(tb_exact, lanes, m, le))
    cb = proto["cornell_box"]
    rec.update(launches=dcounts["direct_grad"], plain_ms=plain_ms, unpacked_ms=exact_ms,
               plain_shape=f"every {CHECK_STRIDE}th lane of {RES[0]}x{RES[1]}, {SPP} spp",
               bound_ms=cb["gbound"][0], bound_by=cb["gbound"][1], library_ms=None,
               ptxas=ptxas["direct_grad_packed"])
    out["direct_grad"] = rec
    notes.append(f"direct_grad packed (cornell box): {rec['launches']} launches, texels "
                 f"{rec['texels']}, rounding flips {rec['rounding_flips']}, max abs diff "
                 f"{rec['max_abs_err']:.3e}, {rec['ms']:.2f} ms (unpacked {exact_ms:.2f} ms)")

    # the BVH kernels on the big mesh at the first CHECK_SAMPLES samples of
    # every CHECK_STRIDE-th lane: path_loop_grad_bvh at (4, True),
    # collocated_grad_bvh packed
    bsub = pl.pixel_lanes(RES, CHECK_SAMPLES, dev)[:, ::CHECK_STRIDE].contiguous()
    ble = torch.full((3, bsub.shape[1]), 1.0 / SPP, device=dev)
    for integrator, kname, knobs, plain in (
            ("path", "path_loop_grad_bvh", (4, True),
             lambda tb, ln, mm, lg: pl.render_path_backward_loop_plain(tb, ln, mm, lg,
                                                                       tb.n_steps)),
            ("collocated", "collocated_grad_bvh", (1, True),
             co.render_collocated_backward_plain)):
        bscene = _bigmesh(dev, integrator)
        expect = ({"path_loop_bvh": 1, "path_loop_grad_bvh": 1, "splat_round": 1}
                  if integrator == "path" else
                  {"collocated_bvh": 1, "collocated_grad_bvh": SPP // 4,
                   "splat_round": SPP // 4})
        bcounts = _splat_drive(bscene, *knobs, TEX, f"24 splat big mesh {integrator}", expect)
        tb1 = _knob_tables(bscene, *knobs, 1)
        fn = getattr(kernels, kname)
        if integrator == "path":
            got, _c = fn(tb1, bsub, m, ble, tb1.n_steps)
        else:
            got, _acc = fn(tb1, bsub, m, ble)
        (want, _x), plain_ms = _sync_ms(lambda: plain(tb1, bsub, m, ble))
        rec = _assert_splat_close(got, want, f"24 {kname} {knobs}", True, knobs[0] > 1)
        if integrator == "path":
            rec["ms"], rec["runs"] = _event_ms(lambda: fn(tb1, lanes, m, le, tb1.n_steps), reps=3)
        else:
            rec["ms"], rec["runs"] = _event_ms(lambda: fn(tb1, lanes, m, le), reps=3)
        base = big[kname] if integrator == "path" else coll[kname]
        key = f"{kname}_merge" if integrator == "path" else f"{kname}_packed"
        rec.update(launches=bcounts[kname], splat_merge=knobs[0], packed_splat=knobs[1],
                   plain_ms=plain_ms, plain_shape=f"every {CHECK_STRIDE}th lane of "
                   f"{RES[0]}x{RES[1]}, the first {CHECK_SAMPLES} of {SPP} samples",
                   bound_ms=base["bound_ms"], bound_by=base["bound_by"], library_ms=None,
                   unsplat_ms=base["ms"], ptxas=ptxas[key])
        out[kname] = rec
        notes.append(f"{kname} {knobs} (big mesh): {rec['launches']} launch(es), texels "
                     f"{rec['texels']}, merge flips {rec['merge_flips']}, rounding flips "
                     f"{rec['rounding_flips']}, max abs diff {rec['max_abs_err']:.3e}, "
                     f"{rec['ms']:.2f} ms (phase 13/17's {base['ms']:.2f} ms); {rec['ptxas']}")
    out["iteration_ms"] = it_ms
    out["ptxas"] = {k: ptxas[k] for k in PTXAS_ENTRIES
                    if k.endswith(("_merge", "_packed", "_merge_gen", "_packed_gen"))}
    print(f"[24 splat] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material: "
          + "; ".join(notes) + f"; the new instantiations' ptxas {json.dumps(out['ptxas'])}; "
          f"card {smi}", flush=True)
    return out


# phase 25: the turns of each lookup's timing (A B B A) and the runs a turn
BOUNCE_TURNS = ("emit", "closest", "closest", "emit")
BOUNCE_REPS = 3
# the samples of each lane that phase 25 holds against the plain versions
# (phases 11, 13, 18 and 22 hold the same kernels on their main paths)
BOUNCE_CHECK_SAMPLES = 2
# the image's mean difference that emitter first may leave against the
# closest lookup (tests/test_fused.py:234: a non-light triangle on
# [0.9999 t, t) of a light hit, the epsilon class)
BOUNCE_MEAN_BAR = 1e-5
# the direct wrappers of a route: (forward, gradient)
DIRECT_ROUTES = {("dense", False): ("direct", "direct_grad"),
                 ("bvh", False): ("direct_bvh", "direct_grad_bvh"),
                 ("dense", True): ("direct_env", "direct_grad_env"),
                 ("bvh", True): ("direct_env_bvh", "direct_grad_env_bvh")}


def _bounce_scenes(dev):
    """Phase 25's scenes: (key, what, scene, res, spp, tex) of the
    protocol by the dense route and by accel="auto", the big mesh, the
    cornell box, apps/example.py's env scene and the lightstage's first
    pattern (14 light triangles), at their main paths' sizes."""
    from zdr_tpu_torch.apps import lightstage

    n_lights, ls_res, ls_spp, _iters, ls_tex, n_pat = lightstage.FULL
    stage = lightstage.build_lightstage(n_lights, device=dev)
    stage.camera = lightstage.make_camera()
    stage.update_lights(lightstage.make_patterns(n_lights, n_pat)[0])
    return (("protocol_dense", "the protocol, dense", _protocol(dev), RES, PROTOCOL_SPP, TEX),
            ("protocol_auto", "the protocol by accel='auto'", _protocol(dev, accel="auto"), RES,
             PROTOCOL_SPP, TEX),
            ("big_mesh", "the big mesh", _bigmesh(dev, "direct"), RES, SPP, TEX),
            ("cornell_box", "the cornell box", _flagship(dev, "direct"), RES, SPP, TEX),
            ("example", "apps/example.py's env scene", _example(dev), RES, SPP, 512),
            ("lightstage", "the lightstage's pattern 0", stage, ls_res, ls_spp, ls_tex))


def _closest_tables(data, camera, cfg, seeds):
    """The direct tables at `seeds` with the closest bounce lookup: the
    emitter-first cap lowered below every scene's light count while they
    are built."""
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.integrators import scene_tables

    cap = scene_tables.MERGED_MAX_LIGHT_TRIS
    scene_tables.MERGED_MAX_LIGHT_TRIS = -1
    try:
        return [pl.build_loop_tables(data, camera, cfg, s) for s in seeds]
    finally:
        scene_tables.MERGED_MAX_LIGHT_TRIS = cap


def _direct_work(kname):
    """A direct wrapper's counted work of its last launch: [tests, visits]."""
    from zdr_tpu_torch import kernels

    k = getattr(kernels, kname)
    if getattr(k, "counts", None) is not None:
        return [int(x) for x in k.counts.tolist()]
    return [int(k.tests), int(k.visits or 0)]


def _bounce_bounds(tb, lanes, m, le, work, gwork, early, n_samples):
    """The bounds of a direct route's counted work, as phases 11, 13 and 18
    count it: the dense kernels' counted-work bound (_direct_bound, the
    early out's operations a test from _early_work on its stride), the BVH
    kernels' tests and visits (_bound), with the env's lookups and samples
    (_direct_env_work) -> (forward bound, gradient bound, operations a
    test)."""
    acc = torch.empty((3, lanes.shape[1]), device=m.device)
    tables = [lanes, m, tb.scene, tb.lights, tb.bn]
    if tb.light_rows is not None:
        tables.append(tb.light_rows)
    if tb.env is not None:
        tables += [tb.env.texture, tb.env.alias_prob, tb.env.alias_idx, tb.env.pdf]
    env_work = _direct_env_work(dataclasses.replace(tb, bvh=None), lanes, m)
    if tb.bvh is not None:
        tables += [tb.bvh.geom, tb.bvh.nodes]
        return (_bound(work[0], _nbytes(*tables, acc), work[1], extra_ops=_env_ops(env_work)),
                _bound(gwork[0], _nbytes(*tables, le, m, acc), gwork[1],
                       extra_ops=_env_ops(env_work, grad=True)), MT_OPS)
    test_ops = _test_ops(_early_work(tb, lanes, m)[0] if early else None)
    return (_direct_bound(work[0], n_samples, _nbytes(*tables, acc), test_ops=test_ops,
                          env_work=env_work),
            _direct_bound(gwork[0], n_samples, _nbytes(*tables, le, m, acc), True, test_ops,
                          env_work), test_ops)


def _bounce_emit_scene(what, scene, res, spp, tex, smi):
    """Phase 25 on one scene: the emitter-first kernels against their plain
    versions (_bvh_check: every CHECK_STRIDE-th lane, the first
    BOUNCE_CHECK_SAMPLES samples), then both lookups at full size in turns A B B A
    (BOUNCE_TURNS): each kernel alone and the iteration through the Scene
    (the cap lowered for the closest lookup), the image and the gradient of
    one against the other, the counted work and its bounds -> the
    numbers."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl
    from zdr_tpu_torch.integrators import scene_tables

    dev = scene.device
    data = scene._render_data("direct")
    cfg = scene._config(res, spp)
    tbs = {"emit": [pl.build_loop_tables(data, scene.camera, cfg, s) for s in (0, 1)],
           "closest": _closest_tables(data, scene.camera, cfg, (0, 1))}
    n_light = len(data.meta.light_tri_ids)
    tb = tbs["emit"][0]
    if tb.light_rows is None or tbs["closest"][0].light_rows is not None:
        raise AssertionError(f"25 {what}: {n_light} light triangles do not route emitter first")
    route = "bvh" if tb.bvh is not None else "dense"
    fwd, bwd = DIRECT_ROUTES[route, tb.env is not None]
    m = torch.full((tex, tex, 4), 0.5, dtype=torch.float32, device=dev)
    err, g_err, plain_ms, gplain_ms, check = _bvh_check(*tbs["emit"], m, "direct", what,
                                                        samples=BOUNCE_CHECK_SAMPLES)

    lanes = pl.pixel_lanes(res, spp, dev)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    mat = m.clone().requires_grad_()
    iteration = _iteration(scene, mat, res, spp)
    turns = {look: dict(ms=[], gms=[], it_ms=[]) for look in ("emit", "closest")}
    out = {}
    cap = scene_tables.MERGED_MAX_LIGHT_TRIS
    for look in BOUNCE_TURNS:
        t0, t1 = tbs[look]
        before = {k: getattr(kernels, k).launches for k in (fwd, bwd)}
        ms, _r = _event_ms(lambda: kernels.direct(t0, lanes, m), BOUNCE_REPS)
        acc = kernels.direct(t0, lanes, m)
        work = _direct_work(fwd)
        plan = getattr(getattr(kernels, fwd), "plan", None)
        gms, _r = _event_ms(lambda: kernels.direct_grad(t1, lanes, m, le), BOUNCE_REPS)
        grad, _acc = kernels.direct_grad(t1, lanes, m, le)
        gwork = _direct_work(bwd)
        # each kernel: _event_ms's warm-up and runs, and the call kept
        if any(getattr(kernels, k).launches - before[k] != 2 + BOUNCE_REPS for k in (fwd, bwd)):
            raise AssertionError(f"25 {what}: {look} did not launch {fwd} and {bwd}")
        scene_tables.MERGED_MAX_LIGHT_TRIS = cap if look == "emit" else -1
        try:
            it_ms, _r = _median_ms(iteration, BOUNCE_REPS)
        finally:
            scene_tables.MERGED_MAX_LIGHT_TRIS = cap
        turns[look]["ms"].append(ms)
        turns[look]["gms"].append(gms)
        turns[look]["it_ms"].append(it_ms)
        out[look] = dict(acc=acc, grad=grad, work=work, gwork=gwork,
                         early=bool(plan and plan.get("early")))

    n_samples = res[0] * res[1] * spp
    img_e, img_c = out["emit"]["acc"] / spp, out["closest"]["acc"] / spp
    diff = (img_e - img_c).abs()
    past = int((diff > GOLDEN_ATOL + GOLDEN_RTOL * img_c.abs()).any(0).sum())
    mean, worst = float(diff.mean()), float(diff.max())
    if not (bool(torch.isfinite(img_e).all()) and mean < BOUNCE_MEAN_BAR):
        raise AssertionError(f"25 {what}: emitter first against the closest lookup mean abs "
                             f"diff {mean:.3e} (bar {BOUNCE_MEAN_BAR}), worst {worst:.3e}")
    g_e, g_c = out["emit"]["grad"], out["closest"]["grad"]
    g_scale = float(g_c.abs().max())
    g_rel = float((g_e - g_c).abs().max()) / max(g_scale, 1e-30)
    g_sums = ((g_e.sum((0, 1)) - g_c.sum((0, 1))).abs() / g_c.sum((0, 1)).abs().clamp_min(1e-30))
    rec = dict(scene=what, tris=int(tb.scene.shape[0]), light_tris=n_light, route=route,
               kernels=[fwd, bwd], env=tb.env is not None, res=list(res), spp=spp,
               max_abs_err=err, g_max_abs_err=g_err, plain_ms=plain_ms, gplain_ms=gplain_ms,
               image_mean_diff=mean, image_worst_diff=worst, pixels_past_golden=past,
               grad_rel_err=g_rel, grad_sum_rel_err=float(g_sums.max()))
    for look in ("emit", "closest"):
        o, tt = out[look], turns[look]
        bound, gbound, test_ops = _bounce_bounds(tbs[look][0], lanes, m, le, o["work"],
                                                 o["gwork"], o["early"], n_samples)
        rec[look] = dict(ms_turns=tt["ms"], grad_ms_turns=tt["gms"],
                         iteration_ms_turns=tt["it_ms"], ms=statistics.median(tt["ms"]),
                         grad_ms=statistics.median(tt["gms"]),
                         iteration_ms=statistics.median(tt["it_ms"]),
                         tests_a_sample=o["work"][0] / n_samples,
                         visits_a_sample=o["work"][1] / n_samples,
                         grad_tests_a_sample=o["gwork"][0] / n_samples,
                         grad_visits_a_sample=o["gwork"][1] / n_samples,
                         bound_ms=bound[0], bound_by=bound[1], grad_bound_ms=gbound[0],
                         grad_bound_by=gbound[1], test_ops=test_ops)
    e, c = rec["emit"], rec["closest"]
    print(f"[25 bounce_emit] {what}: {rec['tris']} tris, {n_light} light tris, {route}"
          f"{' under the envmap' if rec['env'] else ''}, {res[0]}x{res[1]} {spp} spp, {tex}^2 "
          f"material of 0.5; {fwd} and {bwd} emitter first {check}; emitter first vs the "
          f"closest lookup at full size: image mean abs diff {mean:.3e}, worst {worst:.3e}, "
          f"{past} pixels past the golden bar; gradient max|a - b| / max|a| {g_rel:.3e}, "
          f"channel sums rel {float(g_sums.max()):.3e}; turns A B B A (emit, closest, closest, "
          f"emit), medians of {BOUNCE_REPS}: {fwd} {[round(x, 3) for x in turns['emit']['ms']]}"
          f" vs {[round(x, 3) for x in turns['closest']['ms']]} ms, {bwd} "
          f"{[round(x, 3) for x in turns['emit']['gms']]} vs "
          f"{[round(x, 3) for x in turns['closest']['gms']]} ms, iteration "
          f"{[round(x, 2) for x in turns['emit']['it_ms']]} vs "
          f"{[round(x, 2) for x in turns['closest']['it_ms']]} ms; a sample emitter first "
          f"{e['tests_a_sample']:.2f} tests and {e['visits_a_sample']:.2f} visits (closest "
          f"{c['tests_a_sample']:.2f} and {c['visits_a_sample']:.2f}); bounds emitter first "
          f"{e['bound_ms']:.3f} / {e['grad_bound_ms']:.3f} ms ({e['bound_by']}, "
          f"{e['test_ops']:.2f} operations a test), closest {c['bound_ms']:.3f} / "
          f"{c['grad_bound_ms']:.3f} ms; card {smi}", flush=True)
    return rec


def phase_bounce_emit(dev, smi, ptxas, earlier):
    """Phase 25: the direct kernels' emitter-first bounce lookup on the
    protocol (dense and accel="auto"), the big mesh, the cornell box, the
    example's env scene and a lightstage pattern (_bounce_emit_scene each);
    ptxas of every direct instantiation; beside them the main-path
    iterations of phases 11, 13, 18 and 22, which ran emitter first ->
    {scene: numbers, "ptxas": ..., "main_paths": ...}."""
    out = {}
    for key, what, scene, res, spp, tex in _bounce_scenes(dev):
        out[key] = _bounce_emit_scene(what, scene, res, spp, tex, smi)
    out["ptxas"] = {k: v for k, v in ptxas.items() if k.startswith("direct")}
    out["main_paths"] = earlier
    print(f"[25 bounce_emit] ptxas of every direct instantiation {json.dumps(out['ptxas'])}; "
          f"the main paths' iterations emitter first (ms): {json.dumps(earlier)}; card {smi}",
          flush=True)
    return out


def _direct_extra(proto, g, ptxas):
    """The dense direct kernels' record beyond the contract's keys: the
    counted-work bound's terms and the tests-only bound on the protocol,
    the cornell box's numbers beside them, each instantiation's ptxas."""
    cbox = proto["cornell_box"]
    name = "direct_grad" if g else "direct"
    return {
        "bound_terms_ms": proto[f"{g}bound"][2], "bound_tests_ms": proto[f"{g}bound_tests"],
        "test_ops": proto["test_ops"], "early_stages": proto["stages"],
        "cornell_box": {"launches": cbox["launches"][1 if g else 0], "ms": cbox[f"{g}ms"],
                        "plain_ms": cbox[f"{g}plain_ms"], "plain_shape": cbox["plain_shape"],
                        "bound_ms": cbox[f"{g}bound"][0], "bound_by": cbox[f"{g}bound"][1],
                        "bound_terms_ms": cbox[f"{g}bound"][2],
                        "bound_tests_ms": cbox[f"{g}bound_tests"],
                        "test_ops": cbox["test_ops"]},
        "ptxas": {k: v for k, v in ptxas.items() if k in (name, f"{name}_early")},
    }


# the direct env kernels of phase 2's ptxas report, and their no-env twins
ENV_TWINS = {"direct_env": "direct", "direct_env_early": "direct_early",
             "direct_grad_env": "direct_grad", "direct_grad_env_early": "direct_grad_early",
             "direct_env_bvh": "direct_bvh", "direct_grad_env_bvh": "direct_grad_bvh"}


def _bigmesh_env(device):
    """The big mesh (_bigmesh: 50,882 triangles, the quad light) under
    make_test_envmap(256, 512), the direct integrator by accel="auto" (the
    BVH)."""
    from zdr_tpu_torch.envmap import make_test_envmap

    scene = _bigmesh(device, "direct")
    scene.add_envmap(make_test_envmap(256, 512))
    return scene


def _shadow_note(rec, n_samples):
    """A direct env kernel's record's shadow walks, reads and work a sample."""
    return (f"{rec['shadow_walked'] / n_samples:.3f} shadow walks and "
            f"{rec['shadow_skipped'] / n_samples:.3f} skipped a sample (the light sample below "
            f"the hemisphere), {rec['env_read'] / n_samples:.3f} env samples read after the "
            f"walk in tap mode, {rec['tests'] / n_samples:.2f} tests and {rec['visits'] / n_samples:.2f} "
            f"visits a sample, {rec['ms']:.3f} / {rec['bound_ms']:.3f} ms bound")


def phase_env_redesign(dev, smi, ptxas, example, earlier):
    """Phase 26: the direct env BVH kernels as redesigned (the NEE shadow
    walk only where the light sample lies above the hemisphere, in tap mode
    the env sample's pdf and texels read after the walk). The main path: the
    big mesh under the envmap (_slice_main: Scene.render + loss.backward()
    by accel="auto", both kernels against their plain versions, the images
    bit for bit, the gradients at phase 7's bars, each kernel alone with its
    counted work and the bound from it). Beside it the example's records of
    phase 18 (`example`), each scene's shadow walks walked and skipped a
    sample (_direct_env_work), ptxas of the direct env kernels against their
    no-env twins, and the example app's step of phase 22 (`earlier`) -> the
    big mesh's records."""
    records, _img = _slice_main(_bigmesh_env(dev), RES, SPP, 512, "26 env redesign",
                                "the big mesh under the envmap", smi,
                                check_samples=BOUNCE_CHECK_SAMPLES,
                                env_stride=2 * ENV_WORK_STRIDE - 1)
    n_samples = RES[0] * RES[1] * SPP
    notes = []
    for what, recs in (("the example", example), ("the big mesh", records)):
        for k in ("direct_env_bvh", "direct_grad_env_bvh"):
            notes.append(f"{what} {k} {_shadow_note(recs[k], n_samples)}")
    regs = {k: [ptxas[k][f] for f in ("registers", "local_bytes", "spill_stores", "spill_loads")]
            for k in (*ENV_TWINS, *ENV_TWINS.values())}
    spills = {k: regs[k][2] <= regs[t][2] and regs[k][3] <= regs[t][3]
              for k, t in ENV_TWINS.items()}
    print(f"[26 env redesign] {'; '.join(notes)}; ptxas [registers, stack frame bytes, spill "
          f"stores, spill loads] {json.dumps(regs)}; spills no larger than the no-env twin's: "
          f"{json.dumps(spills)}; the example app's step (phase 22) "
          f"{earlier['22 example step']:.2f} ms, the example's iteration by auto (phase 18) "
          f"{earlier['18 example auto']:.2f} ms; card {smi}", flush=True)
    for k in records:
        records[k]["ptxas"] = {e: regs[e] for e in (k, ENV_TWINS[k])}
        records[k]["spills_within_twin"] = spills[k]
    return records


# the path env kernels of phase 2's ptxas report, and their no-env twins
PATH_ENV_TWINS = {"path_loop_env": "path_loop", "path_loop_grad_env": "path_loop_grad",
                  "path_loop_env_bvh": "path_loop_bvh",
                  "path_loop_grad_env_bvh": "path_loop_grad_bvh"}
# phase 27 counts the big mesh's path work on every PATH_ENV_WORK_STRIDE-th
# lane, through the BVH (its plain walk steps all its rays a node at a time)
PATH_ENV_WORK_STRIDE = 2 * ENV_WORK_STRIDE - 1


def _bigmesh_path_env(device):
    """The big mesh (_bigmesh: 50,882 triangles, the quad light) under
    make_test_envmap(256, 512), the path integrator by accel="auto" (the
    BVH)."""
    from zdr_tpu_torch.envmap import make_test_envmap

    scene = _bigmesh(device, "path")
    scene.add_envmap(make_test_envmap(256, 512))
    return scene


def _path_env_note(what, rec, n_samples):
    """A path env kernel's record's shadow walks, work and bound a sample."""
    walked, skipped = rec["shadow_walked"], rec["shadow_skipped"]
    note = (f"{what} {rec['name']}: {walked / n_samples:.3f} shadow walks and "
            f"{skipped / n_samples:.3f} skipped a sample ({skipped / max(walked + skipped, 1):.1%} "
            f"of the shading steps; below the hemisphere {rec['below_env'] / n_samples:.3f} env "
            f"and {rec['below_mesh'] / n_samples:.3f} mesh samples a sample), "
            f"{rec['steps'] / n_samples:.3f} steps a sample")
    if "visits" in rec:
        note += (f", {rec['tests'] / n_samples:.2f} tests and {rec['visits'] / n_samples:.2f} "
                 f"visits a sample")
    if "taps" in rec:
        note += f", {_tap_note(rec['taps'], n_samples)}"
    return note + f", {rec['ms']:.3f} / {rec['bound_ms']:.3f} ms bound ({rec['bound_by']})"


def phase_path_env_redesign(dev, smi, ptxas, path_env):
    """Phase 27: the path env kernels as redesigned (the NEE shadow walk only
    where the light sample lies above the hemisphere; the BVH env gradient
    at 8 blocks of 128 an SM). The main path: the big mesh
    under the envmap (_slice_main: Scene.render + loss.backward() by
    accel="auto", both kernels against their plain
    versions at the first BOUNCE_CHECK_SAMPLES samples of every 64th lane,
    the forward bit for bit, the gradient at phase 7's bars, each kernel
    alone with its counted work (the walk through the BVH on every
    PATH_ENV_WORK_STRIDE-th lane, the taps on the check's lanes) and the
    bound from it). Beside it phase 19's records of the flagship and
    env_scene (`path_env`): each scene's shadow walks walked and skipped a
    sample, the light samples below the hemisphere, the taps; on env_scene
    and the big mesh at every CHECK_STRIDE-th lane, the first
    BOUNCE_CHECK_SAMPLES samples, the BVH forward's tests and node visits
    equal to the plain walk's (_path_walk_counts) and to the tap mode's;
    and ptxas of the four path env kernels against their no-env twins ->
    the big mesh's records."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    big = _bigmesh_path_env(dev)
    records, _img = _slice_main(big, RES, SPP, TEX, "27 path env redesign",
                                "the big mesh under the envmap", smi,
                                check_samples=BOUNCE_CHECK_SAMPLES,
                                work_stride=PATH_ENV_WORK_STRIDE, work_bvh=True)
    n_samples = RES[0] * RES[1] * SPP
    # the tap mode walks what the forward walks: on the same tables (seed 0)
    # and lanes their tests and node visits are equal
    sub = pl.pixel_lanes(RES, BOUNCE_CHECK_SAMPLES, dev)[:, ::CHECK_STRIDE].contiguous()
    m = torch.full((TEX, TEX, 4), 0.5, dtype=torch.float32, device=dev)
    le = torch.full((3, sub.shape[1]), 1.0 / SPP, device=dev)
    same = {}
    for what, scene in (("env_scene", _env_scene(dev)), ("the big mesh", big)):
        tb = pl.build_loop_tables(scene._render_data("path"), scene.camera,
                                  scene._config(RES, SPP), 0)
        kernels.path_loop(tb, sub, m, pl.init_carry(sub), tb.n_steps)
        kernels.path_loop_grad(tb, sub, m, le, tb.n_steps)
        fc = kernels.path_loop_env_bvh.counts.tolist()
        gc = kernels.path_loop_grad_env_bvh.counts.tolist()
        plain = _path_walk_counts(tb, sub, m)
        if fc != gc or fc != [plain["tests"], plain["visits"]]:
            raise AssertionError(f"{what}: path_loop_env_bvh counts {fc} tests and visits, "
                                 f"path_loop_grad_env_bvh {gc} on the same tables, the plain "
                                 f"walk {plain}")
        same[what] = dict(plain, tests_a_sample=fc[0] / (sub.shape[1] * BOUNCE_CHECK_SAMPLES),
                          visits_a_sample=fc[1] / (sub.shape[1] * BOUNCE_CHECK_SAMPLES))
    notes = [f"the tap mode's and the plain walk's tests and node visits equal the forward's "
             f"on the same tables (every {CHECK_STRIDE}th lane, {BOUNCE_CHECK_SAMPLES} "
             f"samples): {json.dumps(same)}"]
    for what, recs, pair in (("the flagship", path_env, SLICE_KERNELS["path", "dense"]),
                             ("env_scene", path_env, SLICE_KERNELS["path", "bvh"]),
                             ("the big mesh", records, SLICE_KERNELS["path", "bvh"])):
        for k in pair:
            notes.append(_path_env_note(what, dict(recs[k], name=k), n_samples))
    regs = {k: [ptxas[k][f] for f in ("registers", "local_bytes", "spill_stores", "spill_loads")]
            for k in (*PATH_ENV_TWINS, *PATH_ENV_TWINS.values())}
    print(f"[27 path env redesign] {'; '.join(notes)}; ptxas [registers, stack frame bytes, "
          f"spill stores, spill loads] {json.dumps(regs)}; card {smi}", flush=True)
    for k in records:
        records[k]["ptxas"] = {e: regs[e] for e in (k, PATH_ENV_TWINS[k])}
    return records


def main():
    t_start = time.perf_counter()
    seconds = {}

    def timed(tag, fn, *args):
        """Run one phase, keeping its seconds for the timing line."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[tag] = round(time.perf_counter() - t0, 1)
        return out

    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ptxas = timed("2", phase_build)
    probe_run = timed("3", phase_sampler_probe, dev)
    timed("4", phase_step, dev)
    timed("5", phase_render, dev)
    main_run = timed("6", phase_main, dev, smi)
    timed("7", phase_grad, dev)
    grad_run = timed("8", phase_main_grad, dev, smi)
    trace_run = timed("9", phase_trace, dev)
    check = timed("10", phase_direct, dev)
    proto, auto = timed("11", phase_main_direct, dev, smi)
    traces = timed("12", phase_trace_bvh, dev, smi)
    big = timed("13", phase_bigmesh, dev, smi)
    variants = timed("14", phase_variants, dev, smi)
    timed("15", phase_crossover, dev, smi)
    timed("16", phase_emissive, dev, smi)
    coll = timed("17", phase_collocated, dev, smi)
    env = timed("18", phase_env, dev, smi)
    path_env = timed("19", phase_path_env, dev, smi)
    samplers = timed("20", phase_samplers, dev, smi, main_run, grad_run,
                     probe_run["by_sampler"], ptxas)
    unfused = timed("21", phase_unfused, dev, smi)
    n_main = len(MAIN_COUNTS)
    apps = timed("22", phase_apps, dev, smi)
    par = timed("23", phase_parallel, dev, smi)
    splat = timed("24", phase_splat, dev, smi, ptxas, grad_run, big, coll, proto)
    earlier = {"11 protocol dense": proto["iteration_ms"],
               "11 cornell box": proto["cornell_box"]["iteration_ms"],
               "11 protocol auto": auto["direct_bvh"]["iteration_ms"],
               "13 big mesh": big["direct_bvh"]["iteration_ms"],
               "18 example auto": env["direct_env_bvh"]["iteration_ms"],
               "18 example dense": env["direct_env"]["iteration_ms"],
               "22 example step": apps["example"]["step_ms"],
               "22 lightstage step": apps["lightstage"]["step_ms"]}
    bounce = timed("25", phase_bounce_emit, dev, smi, ptxas, earlier)
    env_big = timed("26", phase_env_redesign, dev, smi, ptxas, env, earlier)
    path_big = timed("27", phase_path_env_redesign, dev, smi, ptxas, path_env)
    print(f"[timing] seconds a phase {seconds}; {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    # direct_bvh and direct_grad_bvh report the protocol's main path by
    # accel="auto" (phase 11), the big mesh's beside it (phase 13)
    for k in BVH_KERNELS["direct"]:
        big[k] = dict(auto[k], big_mesh=big[k])
    for k in (*BVH_KERNELS["direct"], *BVH_KERNELS["path"]):
        big[k]["ptxas"] = ptxas[k]
    # the probes, the standalone traces and the sweep variants are on no
    # main path: what the main-path calls launched of them
    probe_run["launches"] = sum(c["sampler_probe"] for c in MAIN_COUNTS)
    trace_run["launches"] = sum(c["trace_interact"] for c in MAIN_COUNTS)
    # B3's body (closest_interact) runs inside the megakernels: its launches
    # on the main paths of phases 17-18, by the kernel it runs in
    trace_run["body_launches"] = {k: sum(c[k] for c in MAIN_COUNTS[:n_main])
                                  for k in ("collocated", "collocated_grad", "collocated_bvh",
                                            "collocated_grad_bvh", "direct_env",
                                            "direct_grad_env", "direct_env_bvh",
                                            "direct_grad_env_bvh")}
    # the trace kernels' main path: phase 21's unfused flagship, its numbers
    # on its own bounce call; phase 12's big mesh under "big_mesh"
    for k in TRACES:
        per = (unfused["flagship"]["per_launch"] or {}).get(k)
        big_mesh = {f: v for f, v in traces[k].items() if f != "launches"}
        traces[k] = dict(unfused["records"][k], big_mesh=big_mesh,
                         per_launch_ms_on_the_walk=per[1] if per else None,
                         unfused_launches={d: unfused[d]["launches"][k] for d in (
                             "nearest", "direct_cbox", "direct_protocol_auto")})
    traces["trace_closest"]["unfused_drives"] = {
        k: {f: v for f, v in unfused[k].items() if f != "launches"}
        for k in ("flagship", "nearest", "direct_cbox", "direct_protocol_auto")}
    traces["trace_closest"]["unfused_checks"] = unfused["checks"]
    for k in VARIANTS:
        variants[k]["launches"] = sum(c[k] for c in MAIN_COUNTS)
    # phase 22's apps: their launches and step times under "apps" in the
    # records of the kernels they run
    ex, ls, fdv = apps["example"], apps["lightstage"], apps["fd_validate"]
    for k in ("direct_env_bvh", "direct_grad_env_bvh"):
        env[k]["apps"] = {"example": dict(launches=ex["launches"][k], step_ms=ex["step_ms"])}
    for k in ("direct_bvh", "direct_grad_bvh"):
        err = ls["max_abs_err" if k == "direct_bvh" else "g_max_abs_err"]
        big[k]["apps"] = {"lightstage": dict(launches=ls["launches"][k], step_ms=ls["step_ms"],
                                             max_abs_err=err)}
        big[k]["max_abs_err"] = max(big[k]["max_abs_err"], err)
    main_run["apps"] = {"fd_validate": dict(launches=fdv["launches"]["path_loop"])}
    grad_run["apps"] = {"fd_validate": dict(launches=fdv["launches"]["path_loop_grad"])}
    traces["trace_closest"]["apps"] = {"render_duvdxy": apps["render_duvdxy"]}
    # phase 23's multi-rank runs: launches a rank a call, under "parallel"
    for rec in (main_run, grad_run):
        rec["parallel"] = {b: dict(launches_a_rank=1, ranks=par[b]["ranks"],
                                   lanes_a_rank=par[b]["lanes_a_rank"],
                                   iteration_ms=par[b]["iteration_ms"])
                           for b in ("gloo", "nccl")}
    main_run["parallel"]["dryrun"] = par["dryrun"]
    for kname in ("direct_bvh", "direct_grad_bvh"):
        big[kname]["parallel"] = {
            "batch_gloo": dict(launches_a_rank=par["batch"]["views_a_rank"],
                               ranks=PAR_RANKS, res=list(PAR_BATCH_RES), spp=PAR_BATCH_SPP),
            "lightstage_batched": dict(launches=par["lightstage"]["launches"][kname],
                                       launches_a_step=par["batch"]["views"],
                                       step_ms=par["lightstage"]["step_ms"]),
            "lightstage_small_gate": par["lightstage_small"]}
    env["direct_env_bvh"]["apps"]["adam_step_ms"] = apps["adam_ms"]
    # phase 26's big mesh under the envmap beside the example's main path,
    # phase 27's beside env_scene's
    for k, rec in env_big.items():
        env[k]["big_mesh_env"] = rec
    for k, rec in path_big.items():
        path_env[k]["big_mesh_env"] = rec
    direct_src = "zdr_tpu_torch/kernels/csrc/direct.cu"
    coll_src = "zdr_tpu_torch/kernels/csrc/collocated.cu"
    for pair in SLICE_KERNELS.values():
        for kname in pair:
            rec = coll.get(kname) or env.get(kname) or path_env[kname]
            rec["ptxas"] = {e: v for e, v in ptxas.items() if e in (kname, f"{kname}_early")}
    main_run["ptxas"], grad_run["ptxas"] = ptxas["path_loop"], ptxas["path_loop_grad"]
    main_run["ptxas_gen"] = ptxas["path_loop_gen"]
    grad_run["ptxas_gen"] = ptxas["path_loop_grad_gen"]
    # phase 20's full-width runs of the other samplers, and its checks
    main_run["samplers"] = {k: {f: r[f] for f in ("spp", "launches", "max_abs_err", "ms",
                                                  "plain_ms", "plain_shape", "iteration_ms",
                                                  "ns_a_sample", "bound_ms", "bound_by",
                                                  "bound_terms_ms", "steps", "rounds")}
                            for k, r in samplers["runs"].items()}
    grad_run["samplers"] = {k: {"spp": r["spp"], "launches": r["grad_launches"],
                                "max_abs_err": r["grad_max_abs_err"], "ms": r["grad_ms"],
                                "plain_ms": r["grad_plain_ms"], "plain_shape": r["plain_shape"],
                                "bound_ms": r["grad_bound_ms"]}
                            for k, r in samplers["runs"].items()}
    main_run["sampler_checks"] = samplers["checks"]
    # phase 24's splat knobs: the merged and packed instantiations' numbers
    # under "splat" in the records of the kernels they are instantiations of
    grad_run["splat"] = splat["path_loop_grad"]
    grad_run["splat"]["iteration_ms"] = splat["iteration_ms"]
    big["path_loop_grad_bvh"]["splat"] = splat["path_loop_grad_bvh"]
    coll["collocated_grad_bvh"]["splat"] = splat["collocated_grad_bvh"]
    direct_grad_splat = splat["direct_grad"]
    # phase 25's emitter-first numbers under "bounce_emit" in the records of
    # the kernels each of its scenes ran, by scene
    bounce_emit = {}
    for key, rec in bounce.items():
        if isinstance(rec, dict) and "kernels" in rec:
            for kname in rec["kernels"]:
                bounce_emit.setdefault(kname, {})[key] = rec
    for recs in (big, env):
        for kname, rec in recs.items():
            if kname in bounce_emit:
                rec["bounce_emit"] = bounce_emit[kname]
    bounce_emit["direct"].update(ptxas=bounce["ptxas"], main_paths=bounce["main_paths"])
    variants_src = "zdr_tpu_torch/kernels/csrc/sweep_variants.cu"
    record = {"kernels": [{
        "name": "sampler_probe",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop.cu",
        "replaces": "tools/probe_kernel_sampler.py:20",
        **probe_run,
    }, {
        "name": "path_loop",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop.cu",
        "replaces": "zdr_tpu/integrators/pallas_loop.py:388",
        **main_run,
    }, {
        "name": "path_loop_grad",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop_grad.cu",
        "replaces": "zdr_tpu/integrators/pallas_loop.py:388 (tap mode) + :1082-1286",
        **grad_run,
    }, {
        "name": "trace_interact",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474",
        **trace_run,
    }, {
        "name": "direct",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 + :917 (direct_fused.py:124-268)",
        "launches": proto["launches"][0], "max_abs_err": max(check["err"], proto["err"]),
        "ms": proto["ms"], "plain_ms": proto["plain_ms"], "plain_shape": proto["plain_shape"],
        "bound_ms": proto["bound"][0], "bound_by": proto["bound"][1], "library_ms": None,
        **_direct_extra(proto, "", ptxas), "bounce_emit": bounce_emit["direct"],
    }, {
        "name": "direct_grad",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) + direct_fused.py:289-345",
        "launches": proto["launches"][1], "max_abs_err": max(check["g_err"], proto["g_err"]),
        "ms": proto["gms"], "plain_ms": proto["gplain_ms"], "plain_shape": proto["plain_shape"],
        "bound_ms": proto["gbound"][0], "bound_by": proto["gbound"][1], "library_ms": None,
        **_direct_extra(proto, "g", ptxas), "splat": direct_grad_splat,
        "bounce_emit": bounce_emit["direct_grad"],
    }, {
        "name": "trace_closest",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/accel.cu",
        "replaces": "zdr_tpu/integrators/pallas_stream.py:392 (BVH mode) + "
                    "zdr_tpu/accel/pallas_trace.py:35 (dense mode)",
        **traces["trace_closest"],
    }, {
        "name": "trace_any",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/accel.cu",
        "replaces": "zdr_tpu/integrators/pallas_stream.py:507 (BVH mode) + "
                    "zdr_tpu/accel/pallas_trace.py:103 (dense mode)",
        **traces["trace_any"],
    }, {
        "name": "path_loop_bvh",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop.cu",
        "replaces": "zdr_tpu/integrators/pallas_loop.py:388 with pallas_stream.py:392 + :507 "
                    "(path_fused.py:132-172)",
        **big["path_loop_bvh"],
    }, {
        "name": "path_loop_grad_bvh",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop_grad.cu",
        "replaces": "zdr_tpu/integrators/pallas_loop.py:388 (tap mode) with "
                    "pallas_stream.py:392 + :507",
        **big["path_loop_grad_bvh"],
    }, {
        "name": "direct_bvh",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:861 + :917 with pallas_stream.py:392 "
                    "+ :507 (direct_fused.py:139-240)",
        **big["direct_bvh"],
    }, {
        "name": "direct_grad_bvh",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) with "
                    "pallas_stream.py:392 + :507",
        **big["direct_grad_bvh"],
    }, {
        "name": "sweep_variant",
        "route": "cuda",
        "source": variants_src,
        "replaces": "tools/profile_wide.py:89 + tools/profile_chunk.py:96 + "
                    "tools/profile_sweep_variants.py:156 + tools/profile_mxu_variants.py:101 "
                    "+ :158",
        **variants["sweep_variant"],
    }, {
        "name": "woop_sweep",
        "route": "cuda",
        "source": variants_src,
        "replaces": "tools/profile_mxu_variants.py:212 + tools/profile_sweep_variants.py:156 "
                    "(Woop)",
        **variants["woop_sweep"],
    }, {
        "name": "aabb_sweep",
        "route": "cuda",
        "source": variants_src,
        "replaces": "tools/profile_mxu_variants.py:358",
        **variants["aabb_sweep"],
    }, {
        "name": "floor_probe",
        "route": "cuda",
        "source": variants_src,
        "replaces": "tools/profile_chunk.py:161",
        **variants["floor_probe"],
    }, {
        "name": "collocated",
        "route": "cuda",
        "source": coll_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 (collocated_fused.py:148-210)",
        **coll["collocated"],
    }, {
        "name": "collocated_grad",
        "route": "cuda",
        "source": coll_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 + collocated_fused.py:243 "
                    "(the shade's VJP and the stochastic splat)",
        **coll["collocated_grad"],
    }, {
        "name": "collocated_bvh",
        "route": "cuda",
        "source": coll_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 with pallas_stream.py:392 "
                    "(collocated_fused.py:148-210)",
        **coll["collocated_bvh"],
    }, {
        "name": "collocated_grad_bvh",
        "route": "cuda",
        "source": coll_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 with pallas_stream.py:392 + "
                    "collocated_fused.py:243",
        **coll["collocated_grad_bvh"],
    }, {
        "name": "direct_env",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 + :917 with the env glue of "
                    "direct_fused.py:151-156, :242-251 (fused_glue.py:178-381)",
        **env["direct_env"],
    }, {
        "name": "direct_grad_env",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) with the env glue",
        **env["direct_grad_env"],
    }, {
        "name": "direct_env_bvh",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 with pallas_stream.py:392 + :507 "
                    "and the env glue (direct_fused.py:139-251)",
        **env["direct_env_bvh"],
    }, {
        "name": "direct_grad_env_bvh",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) with "
                    "pallas_stream.py:392 + :507 and the env glue",
        **env["direct_grad_env_bvh"],
    }, {
        "name": "path_loop_env",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop.cu",
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:474 + :917 (path mode) with the "
                    "env glue of path_fused.py:127-150 (fused_glue.py:236, :289-381)",
        **path_env["path_loop_env"],
    }, {
        "name": "path_loop_grad_env",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop_grad.cu",
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (path mode, want_grad) with the "
                    "env glue (path_fused.py:270-471)",
        **path_env["path_loop_grad_env"],
    }, {
        "name": "path_loop_env_bvh",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop.cu",
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (path mode) with "
                    "pallas_stream.py:392 + :507 and the env glue (path_fused.py:127-172)",
        **path_env["path_loop_env_bvh"],
    }, {
        "name": "path_loop_grad_env_bvh",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/path_loop_grad.cu",
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (path mode, want_grad) with "
                    "pallas_stream.py:392 + :507 and the env glue",
        **path_env["path_loop_grad_env_bvh"],
    }, {
        "name": "splat_round",
        "route": "cuda",
        "source": "zdr_tpu_torch/kernels/csrc/splat.cu",
        "replaces": "zdr_tpu/texture.py:186 (segment_scatter_add4's packed flush, "
                    "pallas_loop.py:1254-1258; no Pallas kernel)",
        **splat["splat_round"],
    }]}
    for entry in record["kernels"]:
        for v in entry.values():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"non-finite number in the kernel record: {record}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
