#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. the device: a CUDA card is required; its name and power limit as
     nvidia-smi prints them;
  2. the build: nvcc compiles zdr_tpu_torch/kernels/csrc/ for sm_90a into
     zdr_tpu_torch/kernels/_build/;
  3. the sampler probe kernel, bit for bit against the plain sampler;
  4. one path-loop kernel step (n_steps=1) against loop_step at 128x128,
     from the first carry and after 5 steps;
  5. the whole render at 128x128, 16 spp: kernel against plain version;
  6. the main path: the flagship cornell box (pmj02bn, 512x512, 64 spp,
     1024^2 material of 0.5, seed 0) through Scene.render, its launch
     counts, its image against one plain render, its time, and the time
     of the kernel alone and of its plain version on the same tables;
  7. the gradient kernel at 128x128, 16 spp, a random 64^2 material and a
     random adjoint: against the plain backward (per-channel sums within
     rtol 1e-5; texels whose gradient passes 1e-3 of the largest within
     rtol 1e-4: float atomics sum in a run-dependent order, so the two are
     not bit-exact), and its own radiance bit for bit against the forward
     kernel's render at the same seed;
  8. the path integrator's iteration: the flagship with a material that
     requires grad, loss = image[..., :3].sum(), loss.backward(); the launch
     counts, the gradient finite, nonzero and at phase 7's bars against the
     plain backward; the iteration's time and the gradient kernel's alone
     (medians of 5 after a warm-up), the plain backward's (one run);
  9. the trace_interact kernel, full and lite, on 512^2 random rays over
     the cornell box's table and the 962-triangle sphere + quad's: ints
     equal, floats within atol 1e-6 and rtol 1e-6 of the plain version;
 10. the direct kernel at 128x128, 16 spp on both scenes against its plain
     version at phase 5's bar; the direct_grad kernel against the plain
     backward at phase 7's bars, its radiance bit for bit against direct's;
 11. the main path of the direct integrator, the default one: the
     reference's benchmark protocol (tools/bench_reference.py's sphere of
     962 triangles + quad light, camera and 1024^2 material of 0.5; direct
     + MIS, pmj02bn, 512x512, 256 spp), loss = image[..., :3].sum(),
     loss.backward(): the launch counts, no plain version called, the
     gradient finite and nonzero; both kernels against their plain
     versions on the main path's own inputs at every 64th lane (direct at
     phase 10's bar; direct_grad, with the iteration's adjoint on those
     lanes and 0 elsewhere, at phase 7's bars); the iteration's median,
     Scene.render's and each kernel's alone (CUDA events); then the same
     for the cornell box at 512x512, 64 spp.

Phase 1 prints nvidia-smi's name and power limit on a line of their own.
The next-to-last line is the kernels' JSON record: "launches" on the main
path (every count is set to 0 just before each main-path call and read
just after: phase 6 for path_loop, 8 for path_loop_grad, 11's protocol for
direct and direct_grad; for the two probes, the sum over all of them),
"max_abs_err" the largest difference from the plain version over the
kernel's checks, "ms" the kernel alone at the main path's shapes by CUDA
events, "plain_ms" its plain version by the host clock (on the inputs of
"plain_shape", a subset of the main path's where the full width would take
minutes), and
"bound_ms" the larger of the kernel's FP32 work (ray-triangle tests, 46
operations each, counted in this run) at 67 TFLOP/s and its bytes (each
input read once, each output written once) at 3.35 TB/s. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import math
import os
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
           "direct_grad")
# the launch counts of every main-path call (_drive_main)
MAIN_COUNTS = []
# the H100 SXM's peaks (NVIDIA's data sheet, at 700 W): FP32 outside the
# tensor cores, HBM3
FP32_PEAK, HBM_RATE = 67e12, 3.35e12
# FP32 operations of one Moller-Trumbore ray-triangle test (mt_hit in
# kernels/csrc/path_loop_step.cuh): 2 cross products, 4 dot products, 3
# scalings, a reciprocal, a difference and u + v
MT_OPS = 46


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


def _bound(tests, nbytes):
    """-> (bound_ms, bound_by): the larger of the tests' FP32 operations at
    the FP32 peak and the bytes at the memory rate."""
    t_ops = tests * MT_OPS / FP32_PEAK * 1e3
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


def _flagship(device, integrator="path"):
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light

    scene = zt.Scene(
        [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator=integrator, device=device,
    )
    scene.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                             target=(-0.2, 2.6, -5.0))
    return scene


def _protocol(device):
    """tools/bench_reference.py's scene: a uv sphere of 16 x 32 (960
    triangles) over a 2-triangle quad light of 40, its camera; direct."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_quad, make_uv_sphere

    scene = zt.Scene([(make_uv_sphere(0.5, 16, 32), None, None),
                      (make_quad(size=1.0, y=-2.0), None, 40.0)],
                     integrator="direct", device=device)
    scene.camera = zt.Camera(fov=0.8, origin=(1.5, 0.3, 0.0), target=(0.0, 0.0, 0.0))
    return scene


def _path_tests(tb, lanes, mat, stride=16):
    """The ray-triangle tests of the path-loop kernels' walk, counted on
    every `stride`-th lane with the plain step and scaled to all lanes:
    each step a lane runs sweeps the whole table for its next hit, and a
    shading lane's shadow sweep stops at its first hit."""
    from zdr_tpu_torch.integrators import path_loop as pl

    sub = lanes[:, ::stride].contiguous()
    carry = pl.init_carry(sub)
    n_tris = tb.scene.shape[0]
    fi, ii = pl.F_IDX, pl.I_IDX
    total = 0
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
        total += int(run.sum()) * n_tris + int(first.sum())
        carry = pl.loop_step(carry, tb, sub, mat)
    return total * lanes.shape[1] / sub.shape[1]


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


def phase_build():
    from zdr_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load_library()
    regs = [ln.strip() for ln in kernels.build_info["log"].splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] nvcc sm_90a {time.perf_counter() - t0:.2f} s into "
          f"{os.path.relpath(kernels.BUILD_DIR, ROOT)}; ptxas: {' | '.join(regs)}", flush=True)


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
    tests = _path_tests(tb, lanes, mat)
    bound_ms, bound_by = _bound(tests, _nbytes(lanes, mat, carry0.f, carry0.i, carry0.f,
                                               carry0.i, tb.scene, tb.bn))
    print(f"[6 main] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material via "
          f"Scene.render: {launches} path_loop launch(es), plain version not called; channel "
          f"means {[round(x, 6) for x in means.tolist()]} vs plain (rtol 1e-4), max abs diff "
          f"{max_err:.3e}; Scene.render median {ms:.2f} ms of {[round(t, 2) for t in times]} "
          f"(first {first_ms:.2f} ms) = {n_samples / ms / 1e3:.2f} M samples/s; kernel alone "
          f"{kernel_ms:.2f} ms (CUDA events, median of 5) = {n_samples / kernel_ms / 1e3:.2f} M "
          f"samples/s; plain {plain_ms:.2f} ms = {n_samples / plain_ms / 1e3:.3f} M samples/s; "
          f"{tests:.4g} ray-triangle tests (every 16th lane, scaled) -> bound {bound_ms:.3f} ms "
          f"({bound_by}); card {smi}", flush=True)
    return dict(launches=launches, max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                plain_shape=f"{RES[0]}x{RES[1]} {SPP} spp", bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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
    got, carry = kernels.path_loop_grad(tb, lanes, mat, le, tb.n_steps)
    fwd = kernels.path_loop(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, mat, le, tb.n_steps)
    torch.cuda.synchronize()
    if not torch.equal(carry.f[0:3], fwd.f[0:3]):
        raise AssertionError("path_loop_grad: its radiance differs from the forward kernel's")
    max_err, worst = _assert_grad_close(got, want, "path_loop_grad 128x128")
    print(f"[7 grad] 128x128 16 spp 64^2 material, random adjoint: kernel vs plain backward "
          f"channel sums {[round(x, 6) for x in got.double().sum((0, 1)).tolist()]} (rtol "
          f"1e-5), worst texel rel err {worst:.3e} (rtol 1e-4), max abs diff {max_err:.3e}; "
          f"the kernel's radiance equals the forward kernel's bit for bit", flush=True)


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

    it_ms, it_runs = _median_ms(iteration)
    grad_ms, grad_runs = _event_ms(lambda: kernels.path_loop_grad(tb, lanes, m, le, tb.n_steps))
    n_samples = RES[0] * RES[1] * SPP
    tests = _path_tests(tb, lanes, m)
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
          f"{bound_ms:.3f} ms ({bound_by}); card {smi}", flush=True)
    return dict(launches=launches[1], max_abs_err=max_err, ms=grad_ms, plain_ms=plain_ms,
                plain_shape=f"{RES[0]}x{RES[1]} {SPP} spp", bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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
    from zdr_tpu_torch.integrators import bounce, direct as dr

    return (dr.direct_sample_plain.calls, dr.render_direct_plain.calls,
            dr.render_direct_backward_plain.calls, bounce.trace_interact_plain.calls,
            bounce.shade_plain.calls)


def _direct_main(scene, res, spp, what, smi, reps):
    """One iteration of the direct integrator's main path, checked, then
    timed -> its numbers."""
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
    tests = int(kernels.direct.tests)
    gms, _r = _event_ms(lambda: kernels.direct_grad(tb, lanes, m, le), reps)
    gtests = int(kernels.direct_grad.tests)
    acc = torch.empty((3, lanes.shape[1]), device=dev)
    bound = _bound(tests, _nbytes(lanes, m, acc, tb.scene, tb.lights, tb.bn))
    gbound = _bound(gtests, _nbytes(lanes, m, le, acc, m, tb.scene, tb.lights, tb.bn))
    n_samples = res[0] * res[1] * spp
    print(f"[11 main-direct] {what}: {tb.scene.shape[0]} tris, pmj02bn {res[0]}x{res[1]} {spp} "
          f"spp {TEX}^2 material of 0.5, loss = image[..., :3].sum(), loss.backward(): "
          f"{launches[0]} direct and {launches[1]} direct_grad launch(es), no plain version "
          f"called; loss {float(loss.detach()):.4f}, gradient finite, |g|max "
          f"{float(grad.abs().max()):.4e}; {check}; iteration median {it_ms:.2f} ms of "
          f"{[round(t, 2) for t in it_runs]} (first {first_ms:.2f} ms); Scene.render median "
          f"{render_ms:.2f} ms of {[round(t, 2) for t in render_runs]}; direct alone "
          f"{ms:.2f} ms = {n_samples / ms / 1e3:.2f} M samples/s, {tests:.4g} ray-triangle "
          f"tests -> bound {bound[0]:.3f} ms ({bound[1]}); direct_grad alone {gms:.2f} ms, "
          f"{gtests:.4g} tests -> bound {gbound[0]:.3f} ms ({gbound[1]}); plain versions not "
          f"run at full width; card {smi}", flush=True)
    return dict(launches=launches, ms=ms, gms=gms, bound=bound, gbound=gbound,
                err=float((got - want).abs().max() / spp), g_err=g_err, plain_ms=plain_ms,
                gplain_ms=gplain_ms,
                plain_shape=f"every {CHECK_STRIDE}th lane of {res[0]}x{res[1]}, {spp} spp")


def phase_main_direct(dev, smi):
    proto = _direct_main(_protocol(dev), RES, PROTOCOL_SPP,
                         "the reference's protocol (sphere + quad light)", smi, reps=3)
    cbox = _direct_main(_flagship(dev, "direct"), RES, SPP, "cornell box", smi, reps=5)
    for k in ("err", "g_err"):
        proto[k] = max(proto[k], cbox[k])
    return proto


def main():
    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    probe_run = phase_sampler_probe(dev)
    phase_step(dev)
    phase_render(dev)
    main_run = phase_main(dev, smi)
    phase_grad(dev)
    grad_run = phase_main_grad(dev, smi)
    trace_run = phase_trace(dev)
    check = phase_direct(dev)
    proto = phase_main_direct(dev, smi)
    # the probes are on no main path: what the main-path calls launched of them
    probe_run["launches"] = sum(c["sampler_probe"] for c in MAIN_COUNTS)
    trace_run["launches"] = sum(c["trace_interact"] for c in MAIN_COUNTS)
    direct_src = "zdr_tpu_torch/kernels/csrc/direct.cu"
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
    }, {
        "name": "direct_grad",
        "route": "cuda",
        "source": direct_src,
        "replaces": "zdr_tpu/integrators/pallas_bounce.py:917 (want_grad) + direct_fused.py:289-345",
        "launches": proto["launches"][1], "max_abs_err": max(check["g_err"], proto["g_err"]),
        "ms": proto["gms"], "plain_ms": proto["gplain_ms"], "plain_shape": proto["plain_shape"],
        "bound_ms": proto["gbound"][0], "bound_by": proto["gbound"][1], "library_ms": None,
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
