"""The port's CUDA kernels: build, binding, launch counts.

The sources under csrc/ are compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, into kernels/_build/ (listed
in .gitignore), and loaded with ctypes. The library's name carries a hash of
the sources and flags, so an edit rebuilds it. A failed build raises with
nvcc's output; nothing falls back to the plain PyTorch version.

Each wrapper runs its kernel's plain version when given CPU tensors. On a
CUDA device it checks its tensors, allocates its outputs with torch.empty,
launches on the current stream without synchronising, raises on a launch
error, and counts its launches in `.launches`; any other device raises.

Kernels:
  path_loop       the forward render of the path integrator (csrc/path_loop.cu);
                  plain version: integrators/path_loop.render_path_loop_plain
  path_loop_grad  the PRB texture gradient of the same walk, with its
                  per-sample replay and atomic scatter (csrc/path_loop_grad.cu);
                  plain version: integrators/path_loop.render_path_backward_loop_plain
  sampler_probe   K fresh-sampler draws per lane, for bit-exactness checks;
                  plain version: samplers.sampler_probe_plain
  trace_interact  closest hit + interaction of a ray batch, full or lite
                  (csrc/direct.cu), for checks; plain version:
                  integrators/bounce.trace_interact_plain
  direct          the forward render of the direct integrator
                  (csrc/direct.cu); plain version:
                  integrators/direct.render_direct_plain
  direct_grad     its texture gradient, one atomic tap a sample
                  (csrc/direct.cu); plain version:
                  integrators/direct.render_direct_backward_plain

The direct kernels also add the ray-triangle tests they made into
`.tests`, a one-element int64 tensor on the card (read it after a
synchronise): the work a bound on their time is counted from.

Each source under CUDA_SOURCES is its own library, and the nvcc runs start
together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import types

import torch

from ..integrators.path_loop import (
    F_NAMES,
    I_NAMES,
    N_TAP_PLANES,
    Carry,
    LoopTables,
    init_carry,
    render_path_backward_loop_plain,
    render_path_loop_plain,
)
from ..integrators.bounce import trace_interact_plain
from ..integrators.direct import render_direct_backward_plain, render_direct_plain
from ..integrators.scene_tables import SCENE_COLS
from ..samplers import sampler_probe_plain
from ..samplers.hashes import next_pow2_mask

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CUDA_SOURCES = ("path_loop.cu", "path_loop_grad.cu", "direct.cu")
HEADERS = ("path_loop_step.cuh", "direct_step.cuh")
# -fmad=false and no fast math: the kernel rounds as its plain version does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
HOST_SOURCES = ("path_loop_host.cpp", "direct_host.cpp")
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")
KINDS = {"lcg": 0, "pmj02bn": 1}
# per-sample scratch rows of path_loop_grad (path_loop_step.cuh kTapPlanes):
# the 16 tap planes less u_m (no merge) and flags (the replay runs at the
# sample's end)
GRAD_SCRATCH_PLANES = N_TAP_PLANES - 2
# dynamic shared memory a block may hold on sm_90 (227 KB): the kernels keep
# their tables there
MAX_TABLE_BYTES = 232448
# direct_step.cuh kGeomCols: the direct kernels and trace_interact keep only
# each triangle's geometry in shared memory, in rows of 12 floats
GEOM_COLS = 12

# what the last build did: seconds, and the compiler's report (registers,
# spills) — empty when the library was already built
build_info = {"seconds": 0.0, "log": ""}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library_path(compiler, flags, sources, stem) -> str:
    """BUILD_DIR/<stem>-<hash of the sources, the headers and the flags>.so"""
    digest = hashlib.sha256()
    for name in sources + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join((compiler,) + flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def _compile(compiler, flags, builds) -> list:
    """Compile each (sources, stem) of `builds` into BUILD_DIR, unless a
    library of the same sources and flags is there, all compilers running
    at once -> the libraries' paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    outs, running = [], []
    for sources, stem in builds:
        out = _library_path(compiler, flags, sources, stem)
        outs.append(out)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [compiler, *flags, "-o", tmp, *(os.path.join(CSRC, s) for s in sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running.append((cmd, proc, tmp, out))
    logs = []
    for cmd, proc, tmp, out in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            for _c, other, _t, _o in running:
                other.kill()
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, out)
        logs.append(log)
    if running:
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = "".join(logs)
    return outs


_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


# zdr_path_loop / zdr_path_loop_grad arguments: params, tables, tables_n,
# bn, material, lanes, [le_grad,] f_in, i_in, f_out, i_out, [scratch,
# grad,] n, n_steps
_LOOP_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I]
_GRAD_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I]
# zdr_trace_interact: params, tables, tables_n, rays, active, f_out, i_out,
# n, lite; zdr_direct: params, tables, tables_n, bn, material, lanes, acc,
# tests, n; zdr_direct_grad: the same with le_grad after lanes and grad
# after acc
_TRACE_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _I]
_DIRECT_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _I]
_DIRECT_GRAD_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I]


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Build (if needed) and load the CUDA libraries -> their entries."""
    builds = [((src,), f"libzdr_{src.split('.')[0]}") for src in CUDA_SOURCES]
    fwd, grad, direct_lib = (ctypes.CDLL(p) for p in _compile(_nvcc(), NVCC_FLAGS, builds))
    return types.SimpleNamespace(
        zdr_path_loop=_bind(fwd, "zdr_path_loop", _LOOP_ARGS + [_P]),
        zdr_sampler_probe=_bind(fwd, "zdr_sampler_probe", [_P, _P, _P, _I, _I, _P, _P]),
        zdr_path_loop_grad=_bind(grad, "zdr_path_loop_grad", _GRAD_ARGS + [_P]),
        zdr_trace_interact=_bind(direct_lib, "zdr_trace_interact", _TRACE_ARGS + [_P]),
        zdr_direct=_bind(direct_lib, "zdr_direct", _DIRECT_ARGS + [_P]),
        zdr_direct_grad=_bind(direct_lib, "zdr_direct_grad", _DIRECT_GRAD_ARGS + [_P]),
    )


@functools.lru_cache(maxsize=None)
def load_host_library() -> types.SimpleNamespace:
    """Build (if needed) and load the g++ build of the same per-lane code,
    for tests that run the kernels' code without a card."""
    builds = [((src,), f"libzdr_{src.split('.')[0]}") for src in HOST_SOURCES]
    lib, direct_lib = (ctypes.CDLL(p) for p in _compile("g++", HOST_FLAGS, builds))
    return types.SimpleNamespace(
        zdr_path_loop_host=_bind(lib, "zdr_path_loop_host", _LOOP_ARGS),
        zdr_sampler_probe_host=_bind(lib, "zdr_sampler_probe_host", [_P, _P, _P, _I, _I, _P]),
        zdr_path_loop_grad_host=_bind(lib, "zdr_path_loop_grad_host", _GRAD_ARGS),
        zdr_trace_interact_host=_bind(direct_lib, "zdr_trace_interact_host", _TRACE_ARGS),
        zdr_direct_host=_bind(direct_lib, "zdr_direct_host",
                              [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I]),
    )


def pack_params(kind: str, spp: int, seed: int, *, res=(1, 1), use_tent=True,
                rr_depth=0, max_depth=0, counts=(0, 0, 0, 0), tex=(0, 0),
                bn_res=0, bn_ntex=0):
    """The kernel's integer parameters (path_loop_step.cuh LoopParams)."""
    seed &= 0xFFFFFFFF
    vals = [KINDS[kind], spp, next_pow2_mask(spp), seed - (seed >> 31 << 32),
            res[0], res[1], int(use_tent), rr_depth, max_depth, *counts, *tex,
            bn_res, bn_ntex]
    return (ctypes.c_int * len(vals))(*vals)


def loop_params(tb: LoopTables, material: torch.Tensor):
    counts = (tb.scene.shape[0], tb.lights.shape[0], tb.n_mesh, tb.n_point)
    return pack_params(
        tb.kind, tb.spp, tb.seed, res=tb.res, use_tent=tb.use_tent,
        rr_depth=tb.rr_depth, max_depth=tb.max_depth, counts=counts,
        tex=(material.shape[0], material.shape[1]), bn_res=tb.bn_res,
        bn_ntex=tb.bn_ntex,
    )


def pack_tables(tb: LoopTables) -> torch.Tensor:
    """Scene, light, light-instance, point and camera rows in one buffer."""
    parts = (tb.scene, tb.lights, tb.light_inst, tb.points, tb.cam)
    return torch.cat([t.reshape(-1).to(torch.float32) for t in parts]).contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(dev: torch.device, name: str) -> bool:
    """True on a CUDA device, False on the CPU (the plain version runs)."""
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on a CUDA device or the CPU, got {dev}")
    return dev.type == "cuda"


def check_table_fits(n_tris: int, n_floats: int, integrator: str) -> None:
    """Raise NotImplementedError unless the shared-memory copy of the tables
    (n_floats in all, of which n_tris triangle rows of SCENE_COLS) fits a
    block: the path-loop kernels copy the tables whole, the direct kernels
    and trace_interact with triangle rows of GEOM_COLS (direct_step.cuh
    compact_size)."""
    cols = SCENE_COLS if integrator == "path" else GEOM_COLS
    if (n_floats - n_tris * (SCENE_COLS - cols)) * 4 > MAX_TABLE_BYTES:
        raise NotImplementedError(
            f"{n_tris} triangles exceed the {integrator} kernels' shared-memory "
            "scene table; the BVH is ROADMAP A13"
        )


def _loop_inputs(tb: LoopTables, lanes, material, n_steps, dev, integrator):
    """Check what the path-loop ("path") and direct ("direct") kernels read
    -> (N, packed tables, params)."""
    n = lanes.shape[1]
    _check(lanes, "lanes", torch.int32, (3, n), dev)
    if material.ndim != 3 or material.shape[2] != 4 or min(material.shape[:2]) < 2:
        raise ValueError(f"material must be (H >= 2, W >= 2, 4), got {tuple(material.shape)}")
    _check(material, "material", torch.float32, material.shape, dev)
    if material.data_ptr() % 16:
        raise ValueError("material must be 16-byte aligned for float4 loads")
    if tb.kind not in KINDS:
        raise NotImplementedError(f"{tb.kind} sampler in the path-loop kernel: ROADMAP A4")
    if tb.kind == "pmj02bn":
        _check(tb.bn, "blue noise", torch.float32, (tb.bn_res * tb.bn_res * tb.bn_ntex,), dev)
    tables = pack_tables(tb).to(dev)
    check_table_fits(tb.scene.shape[0], tables.numel(), integrator)
    if n_steps < 0 or n >= 2**31:
        raise ValueError("n_steps must be >= 0 and N < 2**31")
    return n, tables, loop_params(tb, material)


def path_loop(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
              carry: Carry, n_steps: int) -> Carry:
    """Run every lane of `carry` for up to n_steps steps -> the new carry.
    lanes: (3, N) int32 px, py, stop; material: (H, W, 4).

    On the card a lane stops once its samples are done; the plain version
    idles it, which changes only its sampler state (acc_* and sample_idx
    agree)."""
    dev = lanes.device
    if not _on_card(dev, "path_loop"):
        return render_path_loop_plain(tb, lanes, material, carry, n_steps)
    n, tables, params = _loop_inputs(tb, lanes, material, n_steps, dev, "path")
    _check(carry.f, "carry.f", torch.float32, (len(F_NAMES), n), dev)
    _check(carry.i, "carry.i", torch.int32, (len(I_NAMES), n), dev)
    f_out = torch.empty_like(carry.f)
    i_out = torch.empty_like(carry.i)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_path_loop(
        params, tables.data_ptr(), tables.numel(),
        tb.bn.data_ptr() if tb.kind == "pmj02bn" else None,
        material.data_ptr(), lanes.data_ptr(), carry.f.data_ptr(), carry.i.data_ptr(),
        f_out.data_ptr(), i_out.data_ptr(), n, n_steps, stream,
    )
    if rc != 0:
        raise RuntimeError(f"path_loop kernel launch failed: CUDA error {rc}")
    path_loop.launches += 1
    return Carry(f_out, i_out)


path_loop.launches = 0


def path_loop_grad(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                   le_grad: torch.Tensor, n_steps: int):
    """PRB texture gradient of every lane's samples, walked from the first
    carry, given le_grad, the (3, N) float32 adjoint of each of a lane's
    samples -> (d_material (H, W, 4), the final carry, whose acc_* rows are
    the forward render's).

    On the card the float atomics sum the taps in an order that changes
    from run to run, so the gradient's last bits do too."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_grad"):
        return render_path_backward_loop_plain(tb, lanes, material, le_grad, n_steps)
    n, tables, params = _loop_inputs(tb, lanes, material, n_steps, dev, "path")
    _check(le_grad, "le_grad", torch.float32, (3, n), dev)
    carry = init_carry(lanes)
    f_out = torch.empty_like(carry.f)
    i_out = torch.empty_like(carry.i)
    # a sample takes at most max_depth steps: one scratch row per step
    rows = max(tb.max_depth, 1)
    scratch = torch.empty((rows, GRAD_SCRATCH_PLANES, n), dtype=torch.float32, device=dev)
    grad = torch.zeros_like(material)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_path_loop_grad(
        params, tables.data_ptr(), tables.numel(),
        tb.bn.data_ptr() if tb.kind == "pmj02bn" else None,
        material.data_ptr(), lanes.data_ptr(), le_grad.data_ptr(), carry.f.data_ptr(),
        carry.i.data_ptr(), f_out.data_ptr(), i_out.data_ptr(), scratch.data_ptr(),
        grad.data_ptr(), n, n_steps, stream,
    )
    if rc != 0:
        raise RuntimeError(f"path_loop_grad kernel launch failed: CUDA error {rc}")
    path_loop_grad.launches += 1
    return grad, Carry(f_out, i_out)


path_loop_grad.launches = 0


def sampler_probe(kind: str, spp: int, lanes: torch.Tensor, k: int, bn) -> torch.Tensor:
    """(3k, N) draws of a fresh sampler per lane: for each j, next1 then
    next2's x and y. lanes: (4, N) int32 px, py, seed, sample_idx;
    bn = (rows, res, n_tex) blue noise on the same device (pmj02bn)."""
    dev = lanes.device
    if not _on_card(dev, "sampler_probe"):
        return sampler_probe_plain(kind, spp, lanes, k, bn)
    n = lanes.shape[1]
    _check(lanes, "lanes", torch.int32, (4, n), dev)
    if kind not in KINDS:
        raise NotImplementedError(f"{kind} sampler: ROADMAP A4")
    rows, res, n_tex = bn if kind == "pmj02bn" else (None, 0, 0)
    if rows is not None:
        _check(rows, "blue noise", torch.float32, (res * res * n_tex,), dev)
    out = torch.empty((3 * k, n), dtype=torch.float32, device=dev)
    params = pack_params(kind, spp, 0, bn_res=res, bn_ntex=n_tex)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_sampler_probe(
        params, rows.data_ptr() if rows is not None else None, lanes.data_ptr(),
        n, k, out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"sampler_probe kernel launch failed: CUDA error {rc}")
    sampler_probe.launches += 1
    return out


sampler_probe.launches = 0


def trace_interact(scene: torch.Tensor, rays, lite: bool = False):
    """Closest hit + interaction of every ray: scene the (T, 31) table,
    rays 8 (N,) tensors o3, d3, pdf_prev float32 and active int32 -> the
    16 outputs of integrators/bounce.TRACE_NAMES (4 with lite)."""
    dev = scene.device
    if not _on_card(dev, "trace_interact"):
        return trace_interact_plain(scene, rays, lite)
    n = rays[0].shape[0]
    _check(scene, "scene", torch.float32, (scene.shape[0], 31), dev)
    check_table_fits(scene.shape[0], scene.numel(), "direct")
    for k, r in enumerate(rays):
        _check(r, f"rays[{k}]", torch.int32 if k == 7 else torch.float32, (n,), dev)
    f_in = torch.stack(rays[:7]).contiguous()
    n_f, n_i = (3, 1) if lite else (14, 2)
    f_out = torch.empty((n_f, n), dtype=torch.float32, device=dev)
    i_out = torch.empty((n_i, n), dtype=torch.int32, device=dev)
    params = pack_params("lcg", 1, 0, counts=(scene.shape[0], 0, 0, 0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_trace_interact(
        params, scene.data_ptr(), scene.numel(), f_in.data_ptr(), rays[7].data_ptr(),
        f_out.data_ptr(), i_out.data_ptr(), n, int(lite), stream)
    if rc != 0:
        raise RuntimeError(f"trace_interact kernel launch failed: CUDA error {rc}")
    trace_interact.launches += 1
    if lite:
        return (*f_out.unbind(0), i_out[0])
    f, i = f_out.unbind(0), i_out.unbind(0)
    return (*f[0:11], i[0], *f[11:14], i[1])


trace_interact.launches = 0


def direct(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """Every lane's samples 0 .. stop-1 of the direct integrator -> the
    (3, N) float32 sums of their clamped radiances. lanes: (3, N) int32
    px, py, stop; material: (H, W, 4)."""
    dev = lanes.device
    if not _on_card(dev, "direct"):
        return render_direct_plain(tb, lanes, material)
    n, tables, params = _loop_inputs(tb, lanes, material, 0, dev, "direct")
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    tests = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_direct(
        params, tables.data_ptr(), tables.numel(),
        tb.bn.data_ptr() if tb.kind == "pmj02bn" else None,
        material.data_ptr(), lanes.data_ptr(), acc.data_ptr(), tests.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"direct kernel launch failed: CUDA error {rc}")
    direct.launches += 1
    direct.tests = tests
    return acc


direct.launches = 0
direct.tests = None


def direct_grad(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                le_grad: torch.Tensor):
    """Texture gradient of every lane's direct samples, given le_grad, the
    (3, N) float32 adjoint of each of a lane's samples -> (d_material
    (H, W, 4), the (3, N) radiance sums of the same samples, as direct's).

    On the card the float atomics sum the taps in an order that changes
    from run to run, so the gradient's last bits do too."""
    dev = lanes.device
    if not _on_card(dev, "direct_grad"):
        return render_direct_backward_plain(tb, lanes, material, le_grad)
    n, tables, params = _loop_inputs(tb, lanes, material, 0, dev, "direct")
    _check(le_grad, "le_grad", torch.float32, (3, n), dev)
    acc = torch.empty((3, n), dtype=torch.float32, device=dev)
    grad = torch.zeros_like(material)
    tests = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = load_library().zdr_direct_grad(
        params, tables.data_ptr(), tables.numel(),
        tb.bn.data_ptr() if tb.kind == "pmj02bn" else None,
        material.data_ptr(), lanes.data_ptr(), le_grad.data_ptr(), acc.data_ptr(),
        grad.data_ptr(), tests.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"direct_grad kernel launch failed: CUDA error {rc}")
    direct_grad.launches += 1
    direct_grad.tests = tests
    return grad, acc


direct_grad.launches = 0
direct_grad.tests = None
