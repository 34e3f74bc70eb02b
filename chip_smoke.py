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
     collocated kernels (ptxas_bvh), also under "ptxas" in their records;
  3. the sampler probe kernel, bit for bit against the plain sampler;
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
     for bit against its plain version and its gradient at phase 7's bars.

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
and collocated_grad, 18's example by each route for the env kernels; for
the probes, the standalone traces and the sweep variants, the sum over all
of them; trace_interact's "body_launches" counts, by kernel, the launches of
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
both, bytes), with the tests-only bound beside it as "bound_tests_ms" (for
direct and direct_grad, a test of the sweep with the early out counted up to
the place it leaves, EARLY_OPS, "test_ops" a test on average, and the
cornell box's numbers under "cornell_box"). The
last line is {"ok": true,
"device": {...}}.
Imports nothing of JAX.
"""

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
           "direct_grad_env_bvh")
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
# fetch env_fetch 40; the samples whose light selection takes the env run it
# (the share n_env / (n_env + n_point + n_mesh)); a miss's env_miss_add (66)
# is not counted, so the bound is below the work there
ENV_NEE_FP = 85
# A collocated sample's work besides its sweep (collocated_step.cuh, counted
# as DIRECT_FP is): FP32: the camera ray and the clamped accumulation 64, the
# hit's interaction 67, the bilinear fetch 49, the frame 32, a projection 15,
# ggx_brdf 75, 1/t^2 and the radiance 7; the tap mode adds the cotangents 3,
# the channels 12, ggx_spec_droughness 40 and the splat corner 20. INT32: the
# camera's next2 (no permutation) and the tap mode's salt.
COLLOCATED_FP, COLLOCATED_TAP_FP = 309, 75
COLLOCATED_INT, COLLOCATED_TAP_INT = NEXT2_SET_INT, 20
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


def _bound(tests, nbytes, visits=0, ops=MT_OPS, visit_ops=VISIT_OPS):
    """-> (bound_ms, bound_by): the larger of the tests' (`ops` each) and
    node visits' (`visit_ops` each; SLAB_OPS for the sweep variants' tile-box
    tests) FP32 operations at the FP32 peak and the bytes at the memory
    rate."""
    t_ops = (tests * ops + visits * visit_ops) / FP32_PEAK * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _flagship(device, integrator="path", accel="bruteforce"):
    """bench.py's cornell box + light and camera; the dense route unless
    `accel` says otherwise (phases 6, 8 and 11 hold the dense kernels)."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light

    scene = zt.Scene(
        [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator=integrator, accel=accel, device=device,
    )
    scene.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                             target=(-0.2, 2.6, -5.0))
    return scene


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


def _path_work(tb, lanes, mat, stride=16):
    """The work of the path-loop kernels' walk, counted on every
    `stride`-th lane with the plain step and scaled to all lanes -> {tests:
    ray-triangle tests (each step a lane runs sweeps the whole table for its
    next hit, and a shading lane's shadow sweep stops at its first hit),
    steps: the lanes' steps, restarts: the samples begun, glossy: steps
    whose BSDF sample takes the glossy lobe}."""
    from zdr_tpu_torch.integrators import path_loop as pl

    sub = lanes[:, ::stride].contiguous()
    carry = pl.init_carry(sub)
    n_tris = tb.scene.shape[0]
    fi, ii = pl.F_IDX, pl.I_IDX
    work = dict(tests=0, steps=0, restarts=0, glossy=0)
    for _ in range(tb.n_steps):
        flying = carry.i[ii["in_flight"]] != 0
        run = (carry.i[ii["sample_idx"]] < sub[2]) | flying
        if not bool(run.any()):
            break
        shade = run & flying & (carry.i[ii["shade"]] != 0)
        p = tuple(carry.f[fi[k]][shade] for k in ("p_x", "p_y", "p_z"))
        wl = tuple(carry.f[fi[k]][shade] for k in ("wl_x", "wl_y", "wl_z"))
        ok, _u, _v, t = pl._mt_all(tb.scene, p, wl)
        hit = ok & (t > 1e-4) & (t < carry.f[fi["l_dist"]][shade][:, None])
        first = torch.where(hit.any(1), hit.int().argmax(1) + 1, n_tris)
        work["tests"] += int(run.sum()) * n_tris + int(first.sum())
        work["steps"] += int(run.sum())
        work["glossy"] += int((run & (carry.f[fi["u_lobe"]] >= 0.5)).sum())
        before = carry.i[ii["sample_idx"]].clone()
        carry = pl.loop_step(carry, tb, sub, mat)
        # a lane restarts where it begins a sample: it ends in flight at a
        # sample below its stop that it was not in flight at before
        began = (carry.i[ii["in_flight"]] != 0) & ~(flying & (before == carry.i[ii["sample_idx"]]))
        work["restarts"] += int((run & began).sum())
    scale = lanes.shape[1] / sub.shape[1]
    return {k: v * scale for k, v in work.items()}


def _early_work(tb, lanes, mat, stride=4 * CHECK_STRIDE):
    """The early out's tests by the place they leave (accel/trace.py
    early_stages), counted on every `stride`-th lane over the rays that the
    plain direct samples sweep as the kernel does (each primary ray, a
    shading lane's shadow ray, a bouncing lane's bounce ray) -> ((3,) int64
    tests: left after u's numerator, after v's and t's, at the division;
    the lanes (3, N'))."""
    from zdr_tpu_torch.accel.trace import early_stages
    from zdr_tpu_torch.integrators import bounce
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators.path_loop import T_MAX

    sub = lanes[:, ::stride].contiguous()
    stages = torch.zeros(3, dtype=torch.int64, device=lanes.device)
    shading = []
    trace, shade, occluded = dr.trace_interact_plain, dr.shade_plain, bounce.occluded_plain

    def counted_trace(scene, rays, lite=False, bvh=None):
        act = rays[7] != 0
        o, d = tuple(x[act] for x in rays[0:3]), tuple(x[act] for x in rays[3:6])
        stages.add_(early_stages(scene, o, d, torch.full_like(o[0], T_MAX)))
        return trace(scene, rays, lite, bvh)

    def counted_shade(scene, ray, *args, **kw):
        shading[:] = [ray[12] != 0]
        return shade(scene, ray, *args, **kw)

    def counted_occluded(scene, p, wi, dist, bvh=None):
        m = shading[0]
        stages.add_(early_stages(scene, tuple(x[m] for x in p), tuple(x[m] for x in wi),
                                 dist[m], any_hit=True))
        return occluded(scene, p, wi, dist, bvh)

    dr.trace_interact_plain, dr.shade_plain = counted_trace, counted_shade
    bounce.occluded_plain = counted_occluded
    try:
        dr.render_direct_plain(tb, sub, mat)
    finally:
        dr.trace_interact_plain, dr.shade_plain, bounce.occluded_plain = trace, shade, occluded
    return stages.cpu(), sub


def _test_ops(stages=None):
    """FP32 operations of a dense direct kernel's test: MT_OPS, or for the
    sweep with the early out the mean of EARLY_OPS over the places that
    `stages` (_early_work's counts) says its tests leave."""
    if stages is None:
        return MT_OPS
    return sum(n * ops for n, ops in zip(stages.tolist(), EARLY_OPS)) / int(stages.sum())


def _direct_bound(tests, samples, nbytes, grad=False, test_ops=MT_OPS, env_samples=0):
    """The least time of a dense direct launch's counted work -> (bound_ms,
    bound_by, {term: ms}): the larger of its FP32 operations (the kernel's
    counted tests, `test_ops` each (_test_ops), and DIRECT_FP a sample,
    with the taps' DIRECT_TAP_FP in tap mode, and ENV_NEE_FP for each of
    env_samples, the samples whose light selection takes the env) at
    FP32_RATE, the draws' integer operations at INT32_RATE, both together at
    ISSUE_RATE, and the bytes at HBM_RATE."""
    fp = (tests * test_ops + samples * (DIRECT_FP + (DIRECT_TAP_FP if grad else 0))
          + env_samples * ENV_NEE_FP)
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


def _loop_bound(work, nbytes):
    """The least time of a path-loop forward launch's counted work ->
    (bound_ms, bound_by, {term: ms}): the larger of the FP32 operations
    (the sweeps' tests and the steps', STEP_FP and the rest) at FP32_RATE,
    the draws' integer operations at INT32_RATE, both together at
    ISSUE_RATE, and the bytes at HBM_RATE."""
    steps, restarts, glossy = work["steps"], work["restarts"], work["glossy"]
    fp = (work["tests"] * MT_OPS + steps * STEP_FP + glossy * GLOSSY_FP
          + (steps - glossy) * DIFFUSE_FP + restarts * RESTART_FP)
    ints = (steps * 4 * NEXT1_INT + (steps - restarts) * 2 * NEXT2_INT
            + restarts * 3 * NEXT2_SET_INT)
    terms = {"fp32": fp / FP32_RATE * 1e3, "int32": ints / INT32_RATE * 1e3,
             "issue": (fp + ints) / ISSUE_RATE * 1e3, "bytes": nbytes / HBM_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


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


# the four BVH megakernels by a piece of their mangled entry names
BVH_ENTRIES = {"direct_bvh": "direct_bvh_kernelILb0ELb0E",
               "direct_grad_bvh": "direct_bvh_kernelILb1ELb0E",
               "path_loop_bvh": "path_loop_bvh_kernel",
               "path_loop_grad_bvh": "path_loop_grad_bvh_kernel",
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
PTXAS_ENTRIES = {**BVH_ENTRIES, **DIRECT_ENTRIES}


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
    """Phase 2 -> the BVH megakernels' and the dense direct kernels' ptxas
    report (ptxas_bvh)."""
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
          f"{os.path.relpath(kernels.BUILD_DIR, ROOT)}; the BVH megakernels' and the dense "
          f"direct kernels' registers, local bytes (stack frame) and spill bytes: "
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


def phase_sampler_probe(dev):
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.samplers import sampler_probe_plain
    from zdr_tpu_torch.samplers.pmj02bn import bluenoise

    g = torch.Generator().manual_seed(1)
    n, k = RES[0] * RES[1], 8
    lanes = torch.stack([
        torch.randint(0, 4096, (n,), generator=g), torch.randint(0, 4096, (n,), generator=g),
        torch.randint(-2**31, 2**31, (n,), generator=g), torch.randint(0, SPP, (n,), generator=g),
    ]).to(torch.int32).to(dev)
    bn = bluenoise(dev)
    times = {}
    for kind in ("lcg", "pmj02bn"):
        got = kernels.sampler_probe(kind, SPP, lanes, k, bn)
        want = sampler_probe_plain(kind, SPP, lanes, k, bn)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"sampler_probe {kind}: {bad} of {got.numel()} draws differ")
        times[kind] = (_event_ms(lambda: kernels.sampler_probe(kind, SPP, lanes, k, bn))[0],
                       _event_ms(lambda: sampler_probe_plain(kind, SPP, lanes, k, bn))[0])
    print(f"[3 sampler_probe] lcg and pmj02bn bit-exact over {n} lanes x {3 * k} draws; "
          + "; ".join(f"{kk} kernel {a:.3f} ms plain {b:.3f} ms" for kk, (a, b) in times.items()),
          flush=True)
    # integer hashing, no FP32 work: bound by its bytes (lanes, the blue
    # noise table, the draws)
    bound_ms, bound_by = _bound(0, _nbytes(lanes, bn[0]) + 3 * k * n * 4)
    return dict(launches=None, max_abs_err=0.0, ms=times["pmj02bn"][0],
                plain_ms=times["pmj02bn"][1], plain_shape=f"{n} lanes x {3 * k} draws",
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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

    return (dr.direct_sample_plain.calls, dr.render_direct_plain.calls,
            dr.render_direct_backward_plain.calls, bounce.trace_interact_plain.calls,
            bounce.shade_plain.calls, co.collocated_sample_plain.calls)


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
                      f"{shares[2]:.4f} reach the division (the kernel's count of those "
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
            outs = 16 * n if kname == "trace_closest" else 4 * n
            bound = _bound(counts[0], _nbytes(o, d, t_max, t_max, acc.geom, acc.nodes) + outs,
                           counts[1])
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


def _bvh_check(tb, tb1, mat, integrator, what, stride=None, exact=False):
    """Both BVH kernels against their plain walks on the main path's own
    inputs (its tables at seed 0 and 1, its material, the adjoint 1 / spp)
    at every `stride`-th lane (CHECK_STRIDE), the first CHECK_SAMPLES
    samples of each, the forward bit for bit where `exact` -> (forward max
    abs diff a sample, gradient max abs diff, a note)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    dev, spp = mat.device, tb.spp
    stride = stride or CHECK_STRIDE
    sub = pl.pixel_lanes(tb.res, CHECK_SAMPLES, dev)[:, ::stride].contiguous()
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
    diff = (got - want).abs().amax(0) / CHECK_SAMPLES
    mean, within = float(diff.mean()), float((diff <= 1e-5).float().mean())
    if not (mean <= 1e-6 and within >= 0.999):
        raise AssertionError(f"{what} {integrator}: kernel vs plain mean abs diff {mean:.3e}, "
                             f"{within:.4%} within 1e-5")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{what} {integrator}: {int((got != want).any(0).sum())} lanes "
                             f"differ from the plain walk (bit for bit expected)")
    g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what} {integrator} gradient")
    note = (f"at every {stride}th lane, the first {CHECK_SAMPLES} samples "
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


# the kernels of phases 17 and 18 by slice and route: forward, gradient
SLICE_KERNELS = {("collocated", "dense"): ("collocated", "collocated_grad"),
                 ("collocated", "bvh"): ("collocated_bvh", "collocated_grad_bvh"),
                 ("direct", "dense"): ("direct_env", "direct_grad_env"),
                 ("direct", "bvh"): ("direct_env_bvh", "direct_grad_env_bvh")}


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


def _slice_main(scene, res, spp, tex, tag, what, smi, reps=3):
    """One main path of phases 17-18, Scene.render + loss.backward() of
    `scene` (pmj02bn, `res`, `spp`, a tex^2 material of 0.5) by the route
    its accel takes: one launch of each of its two kernels (SLICE_KERNELS)
    and of no other, no plain version called; both kernels against their
    plain versions on the main path's own inputs at every CHECK_STRIDE-th
    lane (the dense kernels over all the samples, the BVH kernels over the
    first CHECK_SAMPLES), the forward bit for bit and the gradient at phase
    7's bars; the iteration's median, Scene.render's and each kernel's
    alone, with its counted work and bound -> (the two kernels' records, the
    image rendered at seed 0)."""
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import collocated as co
    from zdr_tpu_torch.integrators import direct as dr
    from zdr_tpu_torch.integrators import path_loop as pl

    integrator, dev = scene.integrator, scene.device
    data = scene._render_data(integrator)
    route = "bvh" if data.accel is not None else "dense"
    fwd, bwd = SLICE_KERNELS[integrator, route]
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
    fkern, gkern = (kernels.collocated, kernels.collocated_grad) if integrator == "collocated" \
        else (kernels.direct, kernels.direct_grad)
    if route == "bvh":
        err, g_err, plain_ms, gplain_ms, check = _bvh_check(tb, tb1, m, integrator, what,
                                                            exact=True)
        shape = (f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, the first "
                 f"{CHECK_SAMPLES} of {spp} samples")
    else:
        fplain, gplain = (co.render_collocated_plain, co.render_collocated_backward_plain) \
            if integrator == "collocated" \
            else (dr.render_direct_plain, dr.render_direct_backward_plain)
        sub = lanes[:, ::CHECK_STRIDE].contiguous()
        got = fkern(tb, lanes, m)[:, ::CHECK_STRIDE]
        want, plain_ms = _sync_ms(lambda: fplain(tb, sub, m))
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {fwd} vs plain at every {CHECK_STRIDE}th lane: "
                                 f"{int((got != want).any(0).sum())} lanes differ")
        le_sub = torch.zeros((3, lanes.shape[1]), device=dev)
        le_sub[:, ::CHECK_STRIDE] = 1.0 / spp
        ggot, _acc = gkern(tb1, lanes, m, le_sub)
        (gwant, _acc), gplain_ms = _sync_ms(
            lambda: gplain(tb1, sub, m, le_sub[:, ::CHECK_STRIDE].contiguous()))
        g_err, g_worst = _assert_grad_close(ggot, gwant, f"{what}: {bwd}")
        err = 0.0
        shape = f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, {spp} spp"
        check = (f"at every {CHECK_STRIDE}th lane ({sub.shape[1]} lanes x {spp} spp) {fwd} "
                 f"equals its plain version bit for bit, plain {plain_ms:.1f} ms; {bwd} vs plain "
                 f"worst texel rel err {g_worst:.3e} (rtol 1e-4), max abs diff {g_err:.3e}, "
                 f"plain {gplain_ms:.1f} ms")

    it_ms, it_runs = _median_ms(iteration, reps)
    image = scene.render(m, res=res, spp=spp, seed=0)
    render_ms, _r = _median_ms(lambda: scene.render(m, res=res, spp=spp, seed=0), reps)
    le = torch.full((3, lanes.shape[1]), 1.0 / spp, device=dev)
    ms, _r = _event_ms(lambda: fkern(tb, lanes, m), reps)
    fk, gk = getattr(kernels, fwd), getattr(kernels, bwd)
    gms, _r = _event_ms(lambda: gkern(tb1, lanes, m, le), reps)
    acc = torch.empty((3, lanes.shape[1]), device=dev)
    n_samples = res[0] * res[1] * spp
    tables = [lanes, m, tb.scene, tb.lights, tb.bn]
    if tb.env is not None:
        tables += [tb.env.texture, tb.env.alias_prob, tb.env.alias_idx, tb.env.pdf]
    if route == "bvh":
        tables += [tb.bvh.geom, tb.bvh.nodes]
        work, gwork = fk.counts.tolist(), gk.counts.tolist()
        bound = _bound(work[0], _nbytes(*tables, acc), work[1])
        gbound = _bound(gwork[0], _nbytes(*tables, le, acc, m), gwork[1])
        work_note = (f"{work[0]:.4g} tests and {work[1]:.4g} node visits ({work[0] / n_samples:.2f}"
                     f" and {work[1] / n_samples:.2f} a sample)")
        extra, gextra = dict(tests=work[0], visits=work[1]), dict(tests=gwork[0], visits=gwork[1])
    else:
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
                              f"division")
                fk.tests = tests
            test_ops = _test_ops(stages)
            meta = scene._data.meta
            env_samples = n_samples * meta.n_env / meta.n_total
            bound = _direct_bound(tests, n_samples, _nbytes(*tables, acc), test_ops=test_ops,
                                  env_samples=env_samples)
            gbound = _direct_bound(gtests, n_samples, _nbytes(*tables, le, acc, m), True,
                                   test_ops, env_samples)
        work_note = (f"{tests:.4g} tests ({tests / n_samples:.1f} a sample){stage_note}, "
                     f"{test_ops:.2f} FP32 operations a test, block {plan['block']}, "
                     f"{plan['registers']} registers, {plan['waves']:.3f} waves")
        extra = dict(tests=tests, test_ops=test_ops, bound_terms_ms=bound[2])
        gextra = dict(tests=gtests, test_ops=test_ops, bound_terms_ms=gbound[2])
    print(f"[{tag}] {what}: {tb.scene.shape[0]} tris, {route}, pmj02bn {res[0]}x{res[1]} {spp} "
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
    trace_run["body_launches"] = {k: sum(c[k] for c in MAIN_COUNTS)
                                  for k in ("collocated", "collocated_grad", "collocated_bvh",
                                            "collocated_grad_bvh", "direct_env",
                                            "direct_grad_env", "direct_env_bvh",
                                            "direct_grad_env_bvh")}
    for k in ("trace_closest", "trace_any"):
        traces[k]["launches"] = sum(c[k] for c in MAIN_COUNTS)
    for k in VARIANTS:
        variants[k]["launches"] = sum(c[k] for c in MAIN_COUNTS)
    direct_src = "zdr_tpu_torch/kernels/csrc/direct.cu"
    coll_src = "zdr_tpu_torch/kernels/csrc/collocated.cu"
    for pair in SLICE_KERNELS.values():
        for kname in pair:
            rec = coll.get(kname) or env[kname]
            rec["ptxas"] = {e: v for e, v in ptxas.items() if e in (kname, f"{kname}_early")}
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
        **_direct_extra(proto, "", ptxas),
    }, {
        "name": "direct_grad",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) + direct_fused.py:289-345",
        "launches": proto["launches"][1], "max_abs_err": max(check["g_err"], proto["g_err"]),
        "ms": proto["gms"], "plain_ms": proto["gplain_ms"], "plain_shape": proto["plain_shape"],
        "bound_ms": proto["gbound"][0], "bound_by": proto["gbound"][1], "library_ms": None,
        **_direct_extra(proto, "g", ptxas),
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
