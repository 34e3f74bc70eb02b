"""Multi-device rendering on torch.distributed (port of zdr_tpu/parallel.py).

  * `make_mesh`: a 1-D `DeviceMesh` whose dimension is named "px", over the
    ranks of an initialised process group;
  * `render_sharded`: Scene.render with the flat pixel grid (x fastest)
    split into one contiguous slice a rank. Each rank renders its slice
    through integrators/wrapper.render_forward_rays (on the card the
    kernel route on the slice's lanes), and every rank receives the whole
    image. The backward re-estimates each rank's slice at seed + 1 and sums
    the texture gradients with all_reduce, the counterpart of JAX's psum;
  * `render_batch`: B (camera, emission) views split over the same ranks,
    each rank rendering full frames for its views; per-view gradients are
    summed on the rank, then over the ranks.

The image is gathered by an all_reduce (SUM) of a zero image that holds
only the rank's slice, which is exact (the other ranks add zeros): gloo
takes CUDA tensors for all_reduce and broadcast but not for all_gather, and
NCCL refuses two ranks on one device, so several ranks on one card run on
gloo, and NCCL takes one rank a card.

`launch` starts n ranks of one group in new processes (torch.multiprocessing,
the spawn start method), each building its own Scene from a `SceneSpec`
(CUDA tensors are not shipped across processes), and runs rank bodies of
this module on them: `sharded_iteration`, `batch_iteration`,
`dryrun_multichip`. It is bounded in time: the group's
timeout, a deadline for the results, and a kill of every rank on a
failure or at the deadline. torchrun, one rank a card, is the usual way
to start ranks outside it.

The port renders all spp in one call, so the JAX package's spp windows
(max_spp_per_call) have no counterpart here; the image is the same.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing

from .dtypes import Camera
from .integrators import get_integrator
from .integrators.scene_tables import scene_table
from .integrators.wrapper import (
    RenderConfig,
    check_scope,
    pixel_adjoint,
    pixel_grid,
    render_forward,
    render_forward_rays,
    render_grad,
    render_grad_rays,
)
from .scene import Scene, _normalize_emission

AXIS = "px"
# the seed stride between the views of a batch (JAX parallel.py:183)
VIEW_SEED_STRIDE = 7919

__all__ = ["AXIS", "RenderConfig", "SceneSpec", "batch_iteration", "dryrun_multichip",
           "flagship_spec", "launch", "make_mesh", "render_batch", "render_sharded",
           "sharded_iteration"]


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """1-D device mesh over the pixel axis ("px") of the first n_devices
    ranks (all by default) of the initialised process group; every rank of
    the group calls it. `device_type` "cpu" for ranks on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or parallel.launch)")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return init_device_mesh(device_type, (n,), mesh_dim_names=(AXIS,))


def _layout(mesh):
    """-> (group, rank, size) of the pixel axis: the mesh's; with no mesh the
    world's, or (None, 0, 1) where no process group is initialised."""
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 0, 1
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return mesh.get_group(AXIS), mesh.get_local_rank(AXIS), mesh.size()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _with_alpha(rgb: torch.Tensor) -> torch.Tensor:
    return torch.cat([rgb, torch.ones(rgb.shape[:-1] + (1,), dtype=torch.float32,
                                      device=rgb.device)], dim=-1)


class _ShardedRender(torch.autograd.Function):
    """The rank's slice of the pixel grid rendered, the image summed over
    the ranks; the backward re-estimates the slice at seed + 1 and sums
    d_material over the ranks (JAX build_render_sharded)."""

    @staticmethod
    def forward(ctx, material, data, camera, seed: int, cfg: RenderConfig, layout):
        ctx.save_for_backward(material)
        ctx.args = (data, camera, seed, cfg, layout)
        group, rank, n = layout
        w, h = cfg.res
        lo, m = rank * (w * h // n), w * h // n
        coords = pixel_grid(cfg.res, data.device)[lo:lo + m]
        rgb = torch.zeros((w * h, 3), dtype=torch.float32, device=data.device)
        rgb[lo:lo + m] = render_forward_rays(data, material, camera, seed, cfg,
                                             get_integrator(cfg.integrator)[0], coords)
        return _with_alpha(_all_reduce(rgb, group).reshape(h, w, 3))

    @staticmethod
    def backward(ctx, d_image):
        (material,) = ctx.saved_tensors
        data, camera, seed, cfg, (group, rank, n) = ctx.args
        w, h = cfg.res
        lo, m = rank * (w * h // n), w * h // n
        coords = pixel_grid(cfg.res, data.device)[lo:lo + m]
        estimator, backward = get_integrator(cfg.integrator)
        # uint32 wrap: the bits of JAX's int32 seed + 1
        d_mat = render_grad_rays(data, material, camera, (seed + 1) & 0xFFFFFFFF,
                                 pixel_adjoint(d_image, cfg.spp)[lo:lo + m], cfg, estimator,
                                 backward, coords)
        return _all_reduce(d_mat, group), None, None, None, None, None


def render_sharded(scene: Scene, material: torch.Tensor, *, res, spp, seed=0, mesh=None):
    """Scene.render with the pixels split over the mesh's ranks (by default
    the world's) -> the (H, W, 4) image on every rank; differentiable in the
    material like Scene.render, d_material summed over the ranks. Every rank
    of the mesh calls it with the same arguments. W*H must be divisible by
    the mesh size. With no mesh and no process group it is Scene.render.
    The scene's splat_merge is lane-local, so the gradient does not depend
    on the ranks; under packed_splat each rank rounds its own partial
    gradient to bf16 before the sum over the ranks."""
    group, rank, n = _layout(mesh)
    cfg = scene._config(res, spp)
    w, h = cfg.res
    if (w * h) % n != 0:
        raise ValueError(f"pixel count {w * h} not divisible by mesh size {n}")
    if group is None:
        return scene.render(material, res=res, spp=spp, seed=seed)
    scene._check_material(material)
    data = scene._render_data(cfg.integrator)
    check_scope(cfg, material, data)
    return _ShardedRender.apply(material.contiguous(), data, scene.camera, int(seed), cfg,
                                (group, rank, n))


def _emission_rows(emissions, n_inst: int) -> np.ndarray:
    """emissions: (B, I, 3)-like, or B update_lights-style lists -> (B, I, 3)
    float32."""
    if torch.is_tensor(emissions):
        em = emissions.detach().cpu().numpy().astype(np.float32)
    elif isinstance(emissions, np.ndarray):
        em = emissions.astype(np.float32)
    else:
        em = np.stack([np.stack([_normalize_emission(e) for e in pattern])
                       for pattern in emissions])
    if em.ndim != 3 or em.shape[1:] != (n_inst, 3):
        raise ValueError(f"emissions must be (B, {n_inst}, 3), got {em.shape}")
    return em


def _view_data(data, emission: np.ndarray):
    """The scene's data under one view's emission: its own scene rows, which
    the kernels read the emission from; the light structure is the
    scene's."""
    d = dataclasses.replace(data, emission=torch.as_tensor(emission, device=data.device),
                            table=None)
    d.table = scene_table(d)
    return d


class _BatchRender(torch.autograd.Function):
    """The rank's views rendered, the batch summed over the ranks; the
    backward sums its views' gradients at seed + 1, then over the ranks (JAX
    build_render_batched)."""

    @staticmethod
    def forward(ctx, material, views, seed: int, cfg: RenderConfig, layout):
        ctx.save_for_backward(material)
        ctx.args = (views, seed, cfg, layout)
        group, rank, n, b = layout
        base = rank * len(views)
        w, h = cfg.res
        rgb = torch.zeros((b, h, w, 3), dtype=torch.float32, device=material.device)
        for i, (cam, data) in enumerate(views):
            view_seed = (seed + VIEW_SEED_STRIDE * (base + i)) & 0xFFFFFFFF
            rgb[base + i] = render_forward(data, material, cam, view_seed, cfg)[..., :3]
        return _with_alpha(_all_reduce(rgb, group))

    @staticmethod
    def backward(ctx, d_images):
        (material,) = ctx.saved_tensors
        views, seed, cfg, (group, rank, n, b) = ctx.args
        base = rank * len(views)
        d_mat = torch.zeros_like(material)
        for i, (cam, data) in enumerate(views):
            view_seed = (seed + 1 + VIEW_SEED_STRIDE * (base + i)) & 0xFFFFFFFF
            d_mat += render_grad(data, material, cam, view_seed, d_images[base + i], cfg)
        return _all_reduce(d_mat, group), None, None, None, None


def render_batch(scene: Scene, material: torch.Tensor, cameras, emissions, *, res, spp,
                 seed=0, mesh=None):
    """Batched multi-view / multi-light render: one frame per (camera,
    emission) pair, the batch split over the mesh's ranks (by default the
    world's) -> (B, H, W, 4) on every rank; differentiable in the material,
    the views' gradients summed. View k renders at seed + 7919 k. Every rank
    of the mesh calls it with the same arguments.

    cameras: a Camera, or B Cameras. emissions: (B, I, 3)-like, or B
    update_lights-style lists of I emissions. B must be divisible by the
    mesh size. The light structure (which instances emit) is the scene's
    for every view; only the emission values change, so a light off in one
    view keeps a small nonzero emission (JAX parallel.py:153-158)."""
    group, rank, n = _layout(mesh)
    em = _emission_rows(emissions, len(scene.emissions))
    b = em.shape[0]
    if b % n != 0:
        raise ValueError(f"batch {b} not divisible by mesh size {n}")
    if not isinstance(cameras, (list, tuple)):
        cameras = [cameras] * b
    if len(cameras) != b:
        raise ValueError(f"{len(cameras)} cameras for batch {b}")
    scene._check_material(material)
    cfg = scene._config(res, spp)
    data = scene._render_data(cfg.integrator)
    check_scope(cfg, material, data)
    n_local = b // n
    views = [(cameras[k], _view_data(data, em[k]))
             for k in range(rank * n_local, (rank + 1) * n_local)]
    return _BatchRender.apply(material.contiguous(), views, int(seed), cfg, (group, rank, n, b))


# ------------------------------------------------------------ the launcher


@dataclasses.dataclass
class SceneSpec:
    """A Scene as data, for ranks that build their own: Scene(models,
    integrator, accel, device=...), then its camera and the Scene
    attributes of `attrs` (fused, bilinear, use_mis, ...)."""

    models: list
    integrator: str = "direct"
    camera: Optional[Camera] = None
    attrs: dict = dataclasses.field(default_factory=dict)
    accel: str = "auto"

    def build(self, device) -> Scene:
        scene = Scene(self.models, self.integrator, self.accel, device=device)
        if self.camera is not None:
            scene.camera = self.camera
        for k, v in self.attrs.items():
            if not hasattr(scene, k):
                raise AttributeError(f"Scene has no attribute {k!r}")
            setattr(scene, k, v)
        return scene


def _rank_main(rank, n_ranks, backend, init_method, timeout, device, threads, jobs, results):
    """One rank: its device, the group, each job fn(device, **kwargs) in
    order -> (rank, True, [results]) or (rank, False, the traceback) on the
    queue."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if threads:
            torch.set_num_threads(threads)
        # NCCL binds its communicator to the rank's card at once
        bound = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=timeout), **bound)
        out = [fn(dev, **kwargs) for fn, kwargs in jobs]
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        # leave at once: the other ranks may wait in a collective, and the
        # launcher kills them
        os._exit(1)
    results.put((rank, True, out))
    dist.destroy_process_group()


def launch(jobs, n_ranks: int, *, devices, backend: str = "gloo", timeout: float = 600.0,
           threads: Optional[int] = None) -> list:
    """Run `jobs`, a list of (fn, kwargs), in order on each of n_ranks new
    processes that form one process group (a file:// rendezvous in a
    temporary folder): fn(device, **kwargs) on every rank, fn a function a
    spawned process can import (this module's rank bodies) -> results[rank]
    [job], which must pickle (numpy and Python values).

    devices: one device for every rank ("cuda:0": gloo, whose ranks may
    share a card; "cpu") or a list of one a rank (NCCL: one card each). threads: torch's
    threads a rank (the ranks share the host's cores). The kernels are
    built before the ranks start, so that no two ranks build at once. A
    rank's exception is raised here as RuntimeError with its traceback;
    every rank is killed on a failure and once `timeout` seconds have
    passed, which also bounds each collective."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != n_ranks:
            raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
    else:
        devices = [devices] * n_ranks
    if any(torch.device(d).type == "cuda" for d in devices):
        from . import kernels

        kernels.load_library()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="zdr_launch_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, backend, init_method, timeout, str(devices[r]),
                               threads, jobs, results))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    out, dead_since = {}, {}
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n_ranks)) - set(out))} of "
                                   f"{n_ranks} gave no result in {timeout} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        # a rank that posted before it left is read first
                        if now - dead_since.setdefault(r, now) > 5.0:
                            raise RuntimeError(f"rank {r} of {n_ranks} exited with code "
                                               f"{p.exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n_ranks)]


# ------------------------------------------------------------ rank bodies


def _kernel_names() -> list:
    from . import kernels

    return sorted(k for k, v in vars(kernels).items() if callable(v) and hasattr(v, "launches"))


def _launch_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count, or set each to 0."""
    from . import kernels

    if reset:
        for k in _kernel_names():
            getattr(kernels, k).launches = 0
        return {}
    return {k: getattr(kernels, k).launches for k in _kernel_names()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_runs(fn, device, reps: int) -> list:
    """fn's wall-clock ms, each run started together on every rank (a
    barrier) and ended by the device's synchronisation."""
    times = []
    for _ in range(reps):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _iteration(render, material: np.ndarray, weights, device):
    """render(m) with m requiring grad, loss = sum(image[..., :3] *
    weights), loss.backward() -> (image, d_material), on the device."""
    m = torch.as_tensor(material, device=device).requires_grad_()
    img = render(m)
    w = 1.0 if weights is None else torch.as_tensor(weights, device=device)
    (img[..., :3] * w).sum().backward()
    return img.detach(), m.grad


def sharded_iteration(device, spec: SceneSpec, material, res, spp, seed=0, weights=None,
                      reps: int = 0, mesh: bool = False) -> dict:
    """Rank body: spec's scene, render_sharded of the material (numpy)
    over the world's ranks (or a make_mesh mesh of them), loss =
    sum(image[..., :3] * weights) (weights: the image's (H, W, 3) or 1),
    loss.backward() -> {image, grad (numpy), launches (every kernel's
    count, each set to 0 just before the call and read just after),
    ms (reps more iterations' wall-clock ms)}."""
    scene = spec.build(device)
    grid = make_mesh(device_type=device.type) if mesh else None

    def render(m):
        return render_sharded(scene, m, res=res, spp=spp, seed=seed, mesh=grid)

    _launch_counts(reset=True)
    img, grad = _iteration(render, material, weights, device)
    _sync(device)
    launches = _launch_counts()
    ms = _timed_runs(lambda: _iteration(render, material, weights, device), device, reps)
    return dict(image=img.cpu().numpy(), grad=grad.cpu().numpy(), launches=launches, ms=ms)


def batch_iteration(device, spec: SceneSpec, material, patterns, res, spp, seed=0,
                    cameras=None, weights=None, reps: int = 0) -> dict:
    """Rank body: spec's scene, render_batch of the material (numpy) under
    `patterns` (B update_lights-style lists) over the world's ranks, loss =
    sum(images[..., :3] * weights) (weights: (B, H, W, 3) or 1),
    loss.backward() -> {images, grad (numpy), launches, ms}, as
    sharded_iteration's."""
    scene = spec.build(device)
    cams = scene.camera if cameras is None else cameras

    def render(m):
        return render_batch(scene, m, cams, patterns, res=res, spp=spp, seed=seed)

    _launch_counts(reset=True)
    img, grad = _iteration(render, material, weights, device)
    _sync(device)
    launches = _launch_counts()
    ms = _timed_runs(lambda: _iteration(render, material, weights, device), device, reps)
    return dict(images=img.cpu().numpy(), grad=grad.cpu().numpy(), launches=launches, ms=ms)


def flagship_spec(integrator: str = "path", accel: str = "auto", **attrs) -> SceneSpec:
    """bench.py's flagship: the cornell box and its light at 15, its
    camera; the path integrator unless `integrator` says otherwise, and the
    Scene attributes of `attrs`."""
    from .geometry.procedural import make_cornell_box, make_cornell_light

    return SceneSpec(
        models=[(make_cornell_box(), None, None), (make_cornell_light(), None, 15.0)],
        integrator=integrator,
        camera=Camera(fov=50 / 180 * 3.1415926, origin=(-0.2, 2.6, -0.5),
                      target=(-0.2, 2.6, -5.0)),
        attrs=attrs, accel=accel)


def dryrun_multichip(device) -> tuple:
    """Rank body, on every rank of a group (__graft_entry__.py:70-141): the
    sharded flagship training step at 16x16, 2 spp on an 8x8 material of
    0.5 (MSE against the render of material * 0.8 at seed 7, backward, one
    Adam step at lr 1e-2, clamp to [1e-3, 1]), then the batched n-view loss
    (one view a rank, the light at 15 (1 + 0.1 b)) at seeds 3 and 11 ->
    (loss, batched loss); rank 0 prints both."""
    n = dist.get_world_size()
    scene = flagship_spec().build(device)
    mesh = make_mesh(device_type=device.type)
    res, spp = (16, 16), 2
    material = torch.full((8, 8, 4), 0.5, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = render_sharded(scene, material * 0.8, res=res, spp=spp, seed=7, mesh=mesh)
    material.requires_grad_()
    opt = torch.optim.Adam([material], lr=1e-2)
    loss = ((render_sharded(scene, material, res=res, spp=spp, seed=1, mesh=mesh)
             - target) ** 2).sum()
    loss.backward()
    opt.step()
    with torch.no_grad():
        material.clamp_(1e-3, 1.0)
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise AssertionError("dryrun produced non-finite loss")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n}): loss={loss:.6f} ok", flush=True)

    patterns = [[None, 15.0 * (1.0 + 0.1 * b)] for b in range(n)]
    m = material.detach()
    with torch.no_grad():
        btargets = render_batch(scene, m * 0.8, scene.camera, patterns, res=res, spp=spp,
                                seed=3, mesh=mesh)
    m = m.clone().requires_grad_()
    bloss = ((render_batch(scene, m, scene.camera, patterns, res=res, spp=spp, seed=11,
                           mesh=mesh) - btargets) ** 2).sum()
    bloss.backward()
    bloss = float(bloss.detach())
    if not np.isfinite(bloss):
        raise AssertionError("batched dryrun produced non-finite loss")
    if not float(m.grad.abs().sum()) > 0:
        raise AssertionError("batched dryrun produced zero grads")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n}): batched {n}-view loss={bloss:.6f} ok", flush=True)
    return loss, bloss
