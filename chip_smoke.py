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
  8. the main path's iteration: the flagship with a material that requires
     grad, loss = image[..., :3].sum(), loss.backward(); the launch counts,
     the gradient finite, nonzero and at phase 7's bars against the plain
     backward; the iteration's time, the gradient kernel's alone and the
     plain backward's (medians of 5 after a warm-up).

Phase 1 prints nvidia-smi's name and power limit on a line of their own.
The next-to-last line is the kernels' JSON record ("ms": the kernel alone,
the median of 5 runs by CUDA events; "plain_ms": its plain version by the
host clock); the last line is
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


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _flagship(device):
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.geometry.procedural import make_cornell_box, make_cornell_light

    scene = zt.Scene(
        [(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator="path", device=device,
    )
    scene.camera = zt.Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                             target=(-0.2, 2.6, -5.0))
    return scene


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
    kernels.path_loop.launches = 0
    kernels.sampler_probe.launches = 0
    plain_steps, plain_calls = pl.loop_step.calls, pl.render_path_loop_plain.calls
    img, first_ms = _sync_ms(lambda: scene.render(mat, res=RES, spp=SPP, seed=0))
    launches = kernels.path_loop.launches
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
    print(f"[6 main] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material via "
          f"Scene.render: {launches} path_loop launch(es), plain version not called; channel "
          f"means {[round(x, 6) for x in means.tolist()]} vs plain (rtol 1e-4), max abs diff "
          f"{max_err:.3e}; Scene.render median {ms:.2f} ms of {[round(t, 2) for t in times]} "
          f"(first {first_ms:.2f} ms) = {n_samples / ms / 1e3:.2f} M samples/s; kernel alone "
          f"{kernel_ms:.2f} ms (CUDA events, median of 5) = {n_samples / kernel_ms / 1e3:.2f} M "
          f"samples/s; plain {plain_ms:.2f} ms = {n_samples / plain_ms / 1e3:.3f} M samples/s; "
          f"card {smi}", flush=True)
    return dict(launches=launches, max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms)


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

    kernels.path_loop.launches = 0
    kernels.path_loop_grad.launches = 0
    plain = (pl.loop_step.calls, pl.render_path_loop_plain.calls,
             pl.render_path_backward_loop_plain.calls)
    loss, first_ms = _sync_ms(iteration)
    launches = (kernels.path_loop.launches, kernels.path_loop_grad.launches)
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
    want, _ = pl.render_path_backward_loop_plain(tb, lanes, m, le, tb.n_steps)
    max_err, worst = _assert_grad_close(grad, want, "main path gradient")

    it_ms, it_runs = _median_ms(iteration)
    grad_ms, grad_runs = _event_ms(lambda: kernels.path_loop_grad(tb, lanes, m, le, tb.n_steps))
    plain_ms, plain_runs = _median_ms(
        lambda: pl.render_path_backward_loop_plain(tb, lanes, m, le, tb.n_steps))
    n_samples = RES[0] * RES[1] * SPP
    print(f"[8 main-grad] cornell box pmj02bn {RES[0]}x{RES[1]} {SPP} spp {TEX}^2 material, "
          f"loss = image[..., :3].sum(), loss.backward(): {launches[0]} path_loop and "
          f"{launches[1]} path_loop_grad launch(es), no plain version called; loss "
          f"{float(loss.detach()):.4f}; gradient vs plain backward: worst texel rel err {worst:.3e}, max "
          f"abs diff {max_err:.3e}; iteration median {it_ms:.2f} ms of "
          f"{[round(t, 2) for t in it_runs]} (first {first_ms:.2f} ms); path_loop_grad alone "
          f"median {grad_ms:.2f} ms of {[round(t, 2) for t in grad_runs]} (CUDA events) = "
          f"{n_samples / grad_ms / 1e3:.2f} M samples/s; plain backward median {plain_ms:.2f} ms of "
          f"{[round(t, 2) for t in plain_runs]}; card {smi}", flush=True)
    return dict(launches=launches[1], max_abs_err=max_err, ms=grad_ms, plain_ms=plain_ms)


def main():
    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_sampler_probe(dev)
    phase_step(dev)
    phase_render(dev)
    main_run = phase_main(dev, smi)
    phase_grad(dev)
    grad_run = phase_main_grad(dev, smi)
    record = {"kernels": [{
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
