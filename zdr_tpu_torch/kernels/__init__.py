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

The megakernels have two instantiations each: the dense one sweeps the
scene table from shared memory, the BVH one (path_loop_bvh,
path_loop_grad_bvh, path_loop_env_bvh, path_loop_grad_env_bvh, direct_bvh,
direct_grad_bvh, direct_env_bvh, direct_grad_env_bvh, collocated_bvh,
collocated_grad_bvh) walks the BVH in order,
near child first with a short stack, over child-box nodes in global memory
(csrc/trace.cuh, accel/bvh.to_child_nodes) for scenes past shared memory. The
wrappers pick it from the tables (LoopTables.bvh, built once per Scene),
never as a fallback, and count its launches under its own name. The BVH
instantiations keep the light, light-instance, point and camera rows in
shared memory where they fit a block and read them from global memory
past that (small_tables_shared), a launch argument.

Kernels:
  path_loop       the forward render of the path integrator (csrc/path_loop.cu),
                  launched at the block it picks from the SM count and the
                  build's occupancy (loop_launch); `.plan` holds its last
                  launch's block, registers, occupancy and waves;
                  plain version: integrators/path_loop.render_path_loop_plain
  path_loop_grad  the PRB texture gradient of the same walk: a sample's
                  tap rows in shared memory (GRAD_NEAR_ROWS of the route),
                  replayed by its lane, one vector atomic a tap
                  (csrc/path_loop_grad.cu); `.plan` holds its last launch's
                  near rows, block, registers and occupancy;
                  plain version: integrators/path_loop.render_path_backward_loop_plain
                  with splat_merge > 1 (LoopTables.splat_merge) its kMerge
                  instantiations, which merge each group of a lane's taps
                  into one before its atomic; with packed_splat,
                  splat_round after the launch
  path_loop_env, path_loop_grad_env
                  the same under an environment light (LoopTables.env): the
                  kernels' env instantiations, the env's tables in global
                  memory as direct_env's; path_loop and path_loop_grad
                  launch them when the tables carry an env; the same plain
                  versions
  sampler_probe   K fresh-sampler draws per lane, for bit-exactness checks;
                  plain version: samplers.sampler_probe_plain
  trace_interact  closest hit + interaction of a ray batch, full or lite
                  (csrc/direct.cu), for checks; plain version:
                  integrators/bounce.trace_interact_plain
  direct          the forward render of the direct integrator
                  (csrc/direct.cu): its dense kernel sweeps with the
                  early out where accel="auto" would walk the BVH
                  (direct_early), one instantiation each, and the launch
                  picks its block (direct_launch); `.plan` holds the last
                  launch's; plain version:
                  integrators/direct.render_direct_plain
  direct_grad     its texture gradient, one atomic tap a sample
                  (csrc/direct.cu), likewise; with packed_splat
                  (LoopTables.packed_splat) its kPacked instantiation, one
                  launch a group of SPLAT_BATCH samples into a scratch,
                  each followed by splat_round's round-add; plain version:
                  integrators/direct.render_direct_backward_plain
  direct_env, direct_grad_env
                  the same under an environment light (LoopTables.env):
                  the kernels' env instantiations, their tables in global
                  memory (not in the shared-memory tables, whose limit they
                  leave as it is); direct and direct_grad launch them when
                  the tables carry an env; the same plain versions
  collocated      the forward render of the collocated integrator
                  (csrc/collocated.cu, the dense sweep without the early
                  out, the block picked at launch; `.plan` as direct's);
                  plain version:
                  integrators/collocated.render_collocated_plain
  collocated_grad its texture gradient, one atomic tap a sample, likewise
                  (packed_splat as direct_grad's); plain version:
                  integrators/collocated.render_collocated_backward_plain
  splat_round     the packed splat's epilogue (csrc/splat.cu): the
                  gradient's texels rounded to bf16 in place, or a scratch
                  gradient rounded and added into it and zeroed; plain
                  version: texture.round_bf16
  trace_closest   closest hit of a ray batch, dense or through the BVH
  trace_any       any hit of a ray batch, likewise (csrc/accel.cu); plain
                  versions: accel/trace.trace_closest_plain, trace_any_plain
  sweep_variant   the dense sweep at a grid point of kTile rows a tile and R
                  rays a thread, closest, any, or with trace_interact's full
                  or lite epilogue (csrc/sweep_variants.cu);
  woop_sweep      the dense sweep by the Woop test;
  aabb_sweep      the sweep with per-tile box culls, MT or Woop;
  floor_probe     a + b, the floor of the timing harness: the measurement
                  kernels of the TPU tools (B9), on no render path; plain
                  versions: accel/variants.*_plain

The direct kernels add the ray-triangle tests they made into `.tests` (and
their BVH node visits into `.visits`), int64 tensors on the card (read them
after a synchronise): the work a bound on their time is counted from. The
BVH instantiations and the trace kernels keep both in `.counts`, a
two-element int64 tensor: tests, visits; the sweep variants keep tests and
tile-box tests there.

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
from ..integrators.collocated import (
    render_collocated_backward_plain,
    render_collocated_plain,
)
from ..envmap import SAMPLE_MAP_H, SAMPLE_MAP_W
from ..accel.trace import trace_any_plain, trace_closest_plain
# SPLAT_BATCH: the samples of a packed direct or collocated gradient launch
# (splat.cuh kSplatBatch)
from ..texture import SPLAT_BATCH, round_bf16
from ..accel.variants import (
    MODES,
    aabb_sweep_plain,
    floor_probe_plain,
    sweep_variant_plain,
    woop_sweep_plain,
)
from ..accel.build import DENSE_MAX_TRIS
from ..accel.bvh import COUNT_BITS, NODE_COLS
from ..accel.types import GEOM_COLS
from ..integrators.scene_tables import SCENE_COLS
from ..samplers import sampler_probe_plain
from ..samplers.corrmj import grid_side
from ..samplers.hashes import next_pow2_mask

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CUDA_SOURCES = ("path_loop.cu", "path_loop_grad.cu", "direct.cu", "accel.cu",
                "sweep_variants.cu", "collocated.cu", "splat.cu")
HEADERS = ("path_loop_step.cuh", "direct_step.cuh", "trace.cuh", "sweep_variants.cuh",
           "launch.cuh", "collocated_step.cuh", "splat.cuh")
# -fmad=false and no fast math: the kernel rounds as its plain version does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
HOST_SOURCES = ("path_loop_host.cpp", "direct_host.cpp", "accel_host.cpp",
                "sweep_variants_host.cpp", "collocated_host.cpp")
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")
KINDS = {"lcg": 0, "pmj02bn": 1, "corrmj": 2}
# the floats of a tap row of path_loop_grad (path_loop_step.cuh kRowPlanes):
# the 16 tap planes less u_m (no merge) and flags (the replay runs at the
# sample's end), with Q and S as bq, u0 and u3; the kMerge instantiations
# keep u_m too (row_planes<true>)
GRAD_ROW_PLANES = N_TAP_PLANES - 3
# the most tap rows of a sample that the gradient kernels keep in shared
# memory, by route (zdr_path_loop_grad_plan takes fewer where the tables
# leave less), from studies/grad_split.py on an H100: the dense
# kernel is fastest at 8 (the flagship's samples end by then but for 0.1%
# of their rows); on the BVH route every row in shared memory costs the
# walk's L1, and 0 is fastest
GRAD_NEAR_ROWS = {"dense": 8, "bvh": 0}
# dynamic shared memory a block may hold on sm_90 (227 KB): the kernels keep
# their tables there (trace.cuh kGeomCols = GEOM_COLS: the direct kernels and
# trace_interact keep only each triangle's geometry there, in rows of 12)
MAX_TABLE_BYTES = 232448
# what the last build did: seconds (0 when every library was already
# built), and the compiler's report of the libraries (registers, spills),
# kept beside each library as <library>.log
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
    at once -> the libraries' paths. build_info gets the seconds and the
    compilers' reports, read back from BUILD_DIR for a library built
    before."""
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
    for cmd, proc, tmp, out in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            for _c, other, _t, _o in running:
                other.kill()
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{log}")
        with open(f"{out}.log", "w") as fh:
            fh.write(log)
        os.replace(tmp, out)
    build_info["seconds"] = time.perf_counter() - t0 if running else 0.0
    logs = []
    for out in outs:
        if os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as fh:
                logs.append(fh.read())
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
# bn, material, lanes, [le_grad,] f_in, i_in, f_out, i_out, [far, grad,] n,
# n_steps[, k_near]
_LOOP_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I]
_GRAD_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I]
# zdr_trace_interact: params, tables, tables_n, rays, active, f_out, i_out,
# n, lite; zdr_direct (and its host build): params, tables, tables_n, bn,
# material, lanes, le_grad (null: the forward), acc, grad, counts, n,
# early; the card's then block and plan
_TRACE_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _I]
_DIRECT_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I]
# the BVH: nodes, geom, n_nodes, n_rows
_BVH_ARGS = [_P, _P, _I, _I]
# the BVH instantiations take small_shared after tables_n: zdr_path_loop_bvh:
# _LOOP_ARGS, the BVH, counts; zdr_path_loop_grad_bvh: _GRAD_ARGS, the BVH,
# counts; zdr_direct_bvh: params, tables, tables_n, small_shared, bn,
# material, lanes, le_grad, acc, grad, the BVH, counts, n
_LOOP_BVH_ARGS = _LOOP_ARGS[:3] + [_I] + _LOOP_ARGS[3:] + _BVH_ARGS + [_P]
_GRAD_BVH_ARGS = _GRAD_ARGS[:3] + [_I] + _GRAD_ARGS[3:] + _BVH_ARGS + [_P]
_DIRECT_BVH_ARGS = [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P] + _BVH_ARGS + [_P, _I]
# an envmap: texture, h, w, alias probabilities, alias indices, pdf; the env
# entries take it after _DIRECT_ARGS (zdr_direct_env, then block and plan)
# or _DIRECT_BVH_ARGS (zdr_direct_env_bvh), the host build after
# _DIRECT_ARGS, then _BVH_ARGS (null nodes and no rows: the dense sweep);
# the path loop's after _LOOP_ARGS (zdr_path_loop_env, then block and
# plan), _LOOP_BVH_ARGS (zdr_path_loop_env_bvh, likewise), _GRAD_ARGS
# (zdr_path_loop_grad_env) or _GRAD_BVH_ARGS (zdr_path_loop_grad_env_bvh,
# and the host build zdr_path_loop_env_host)
_ENV_ARGS = [_P, _I, _I, _P, _P, _P]
# zdr_collocated: _DIRECT_ARGS without early, then block and plan;
# zdr_collocated_bvh: _DIRECT_BVH_ARGS; the host build: _DIRECT_ARGS
# without early, then _BVH_ARGS
_COLLOCATED_ARGS = _DIRECT_ARGS[:11]
# zdr_trace_closest: bvh_mode (0: dense; 1: the BVH), geom, n_rows, nodes,
# n_nodes, o, d, t_min, t_max, t, u, v, prim, counts, n; zdr_trace_any: the
# same with occ in place of t, u, v, prim
_CLOSEST_ARGS = [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I]
_ANY_ARGS = [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I]
# zdr_sweep_variant: mode, tile, r, woop, cull, rows, geom, table, boxes,
# n_tris, rays, active, f_out, i_out, counts, n (the host build: without r)
_VARIANT_HOST_ARGS = [_I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I]
_VARIANT_ARGS = _VARIANT_HOST_ARGS[:2] + [_I] + _VARIANT_HOST_ARGS[2:]


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Build (if needed) and load the CUDA libraries -> their entries."""
    builds = [((src,), f"libzdr_{src.split('.')[0]}") for src in CUDA_SOURCES]
    fwd, grad, direct_lib, accel_lib, variants_lib, coll_lib, splat_lib = (
        ctypes.CDLL(p) for p in _compile(_nvcc(), NVCC_FLAGS, builds))
    return types.SimpleNamespace(
        # the forward kernels take the block and the plan's ints before the stream
        zdr_path_loop=_bind(fwd, "zdr_path_loop", _LOOP_ARGS + [_I, _P, _P]),
        zdr_path_loop_bvh=_bind(fwd, "zdr_path_loop_bvh", _LOOP_BVH_ARGS + [_I, _P, _P]),
        zdr_sampler_probe=_bind(fwd, "zdr_sampler_probe", [_P, _P, _P, _I, _I, _P, _P]),
        zdr_path_loop_grad=_bind(grad, "zdr_path_loop_grad", _GRAD_ARGS + [_P]),
        zdr_path_loop_grad_bvh=_bind(grad, "zdr_path_loop_grad_bvh", _GRAD_BVH_ARGS + [_P]),
        zdr_path_loop_grad_plan=_bind(grad, "zdr_path_loop_grad_plan", [_P, _I, _I, _I, _P]),
        zdr_path_loop_env=_bind(fwd, "zdr_path_loop_env", _LOOP_ARGS + _ENV_ARGS + [_I, _P, _P]),
        zdr_path_loop_env_bvh=_bind(fwd, "zdr_path_loop_env_bvh",
                                    _LOOP_BVH_ARGS + _ENV_ARGS + [_I, _P, _P]),
        zdr_path_loop_grad_env=_bind(grad, "zdr_path_loop_grad_env",
                                     _GRAD_ARGS + _ENV_ARGS + [_P]),
        zdr_path_loop_grad_env_bvh=_bind(grad, "zdr_path_loop_grad_env_bvh",
                                         _GRAD_BVH_ARGS + _ENV_ARGS + [_P]),
        zdr_trace_interact=_bind(direct_lib, "zdr_trace_interact", _TRACE_ARGS + [_P]),
        zdr_direct=_bind(direct_lib, "zdr_direct", _DIRECT_ARGS + [_I, _P, _P]),
        zdr_direct_bvh=_bind(direct_lib, "zdr_direct_bvh", _DIRECT_BVH_ARGS + [_P]),
        zdr_direct_env=_bind(direct_lib, "zdr_direct_env",
                             _DIRECT_ARGS + _ENV_ARGS + [_I, _P, _P]),
        zdr_direct_env_bvh=_bind(direct_lib, "zdr_direct_env_bvh",
                                 _DIRECT_BVH_ARGS + _ENV_ARGS + [_P]),
        zdr_collocated=_bind(coll_lib, "zdr_collocated", _COLLOCATED_ARGS + [_I, _P, _P]),
        zdr_collocated_bvh=_bind(coll_lib, "zdr_collocated_bvh", _DIRECT_BVH_ARGS + [_P]),
        zdr_trace_closest=_bind(accel_lib, "zdr_trace_closest", _CLOSEST_ARGS + [_P]),
        zdr_trace_any=_bind(accel_lib, "zdr_trace_any", _ANY_ARGS + [_P]),
        zdr_sweep_variant=_bind(variants_lib, "zdr_sweep_variant", _VARIANT_ARGS + [_P]),
        zdr_floor_probe=_bind(variants_lib, "zdr_floor_probe", [_P, _P, _P, _I, _P]),
        zdr_sweep_points=_bind(variants_lib, "zdr_sweep_points", [_P, _I]),
        # grad, scratch (null: in place), n, stream
        zdr_splat_round=_bind(splat_lib, "zdr_splat_round", [_P, _P, ctypes.c_longlong, _P]),
    )


@functools.lru_cache(maxsize=None)
def variant_points() -> tuple:
    """The grid points csrc/sweep_variants.cu is built for, as its library
    lists them -> ((mode, kTile, R, woop, cull), ...): sweep_variant's have
    neither woop nor cull, woop_sweep's woop alone, aabb_sweep's cull."""
    lib = load_library()
    n = lib.zdr_sweep_points(None, 0)
    flat = (ctypes.c_int * (5 * n))()
    lib.zdr_sweep_points(flat, n)
    return tuple((MODES[flat[5 * k]], flat[5 * k + 1], flat[5 * k + 2], bool(flat[5 * k + 3]),
                  bool(flat[5 * k + 4])) for k in range(n))


@functools.lru_cache(maxsize=None)
def load_host_library() -> types.SimpleNamespace:
    """Build (if needed) and load the g++ build of the same per-lane code,
    for tests that run the kernels' code without a card."""
    builds = [((src,), f"libzdr_{src.split('.')[0]}") for src in HOST_SOURCES]
    lib, direct_lib, accel_lib, variants_lib, coll_lib = (
        ctypes.CDLL(p) for p in _compile("g++", HOST_FLAGS, builds))
    return types.SimpleNamespace(
        zdr_path_loop_host=_bind(lib, "zdr_path_loop_host", _LOOP_ARGS),
        zdr_gen_sampler_host=_bind(lib, "zdr_gen_sampler_host", [_P]),
        # wo, wi, rough, g_spec, out, n
        zdr_ggx_droughness_host=_bind(lib, "zdr_ggx_droughness_host", [_P] * 5 + [_I]),
        # x, out, n: splat.cuh round_bf16
        zdr_round_bf16_host=_bind(lib, "zdr_round_bf16_host", [_P, _P, _I]),
        zdr_sampler_probe_host=_bind(lib, "zdr_sampler_probe_host", [_P, _P, _P, _I, _I, _P]),
        zdr_path_loop_grad_host=_bind(lib, "zdr_path_loop_grad_host", _GRAD_ARGS),
        # the forward when le_grad (8th) is null
        zdr_path_loop_bvh_host=_bind(lib, "zdr_path_loop_bvh_host", _GRAD_BVH_ARGS),
        # the env instantiations: the forward when le_grad is null, the dense
        # sweep when nodes is null and n_rows 0
        zdr_path_loop_env_host=_bind(lib, "zdr_path_loop_env_host",
                                     _GRAD_BVH_ARGS + _ENV_ARGS),
        zdr_trace_interact_host=_bind(direct_lib, "zdr_trace_interact_host", _TRACE_ARGS),
        zdr_direct_host=_bind(direct_lib, "zdr_direct_host", _DIRECT_ARGS),
        # rows, n_tris, rays, n, any, sweep, f_out, i_out, counts
        zdr_sweep_host=_bind(direct_lib, "zdr_sweep_host", [_P, _I, _P, _I, _I, _I, _P, _P, _P]),
        zdr_direct_bvh_host=_bind(direct_lib, "zdr_direct_bvh_host", _DIRECT_BVH_ARGS),
        zdr_direct_env_host=_bind(direct_lib, "zdr_direct_env_host",
                                  _DIRECT_ARGS + _ENV_ARGS + _BVH_ARGS),
        zdr_collocated_host=_bind(coll_lib, "zdr_collocated_host",
                                  _COLLOCATED_ARGS + _BVH_ARGS),
        zdr_trace_closest_host=_bind(accel_lib, "zdr_trace_closest_host", _CLOSEST_ARGS),
        zdr_trace_any_host=_bind(accel_lib, "zdr_trace_any_host", _ANY_ARGS),
        zdr_sweep_variant_host=_bind(variants_lib, "zdr_sweep_variant_host",
                                     _VARIANT_HOST_ARGS),
    )


def pack_params(kind: str, spp: int, seed: int, *, res=(1, 1), use_tent=True,
                rr_depth=0, max_depth=0, counts=(0, 0, 0, 0), tex=(0, 0),
                bn_res=0, bn_ntex=0, n_env=0, splat_merge=1, packed_splat=False, first=0,
                emit_first=False):
    """The kernel's integer parameters (path_loop_step.cuh LoopParams);
    corrmj's grid side and its mask as samplers/corrmj.py computes them;
    the splat knobs, and the first sample of a packed gradient launch; then
    whether the direct kernels' bounce ray looks up its emitter first
    (direct_step.cuh light_rows_of: the tables then end with the light
    triangles' scene-row ids, direct_tables)."""
    if spp <= 0:
        raise ValueError(f"spp must be >= 1, got {spp}")
    seed &= 0xFFFFFFFF
    cmj_res = grid_side(spp) if kind == "corrmj" else 0
    vals = [KINDS[kind], spp, next_pow2_mask(spp), seed - (seed >> 31 << 32),
            res[0], res[1], int(use_tent), rr_depth, max_depth, *counts, *tex,
            bn_res, bn_ntex, n_env, cmj_res, next_pow2_mask(cmj_res) if cmj_res else 0,
            max(int(splat_merge), 1), int(bool(packed_splat)), first, int(bool(emit_first))]
    return (ctypes.c_int * len(vals))(*vals)


def loop_params(tb: LoopTables, material: torch.Tensor, first: int = 0):
    counts = (tb.scene.shape[0], tb.lights.shape[0], tb.n_mesh, tb.n_point)
    return pack_params(
        tb.kind, tb.spp, tb.seed, res=tb.res, use_tent=tb.use_tent,
        rr_depth=tb.rr_depth, max_depth=tb.max_depth, counts=counts,
        tex=(material.shape[0], material.shape[1]), bn_res=tb.bn_res,
        bn_ntex=tb.bn_ntex, n_env=tb.n_env, splat_merge=tb.splat_merge,
        packed_splat=tb.packed_splat, first=first, emit_first=tb.light_rows is not None,
    )


def pack_tables(tb: LoopTables) -> torch.Tensor:
    """Scene, light, light-instance, point and camera rows in one buffer."""
    parts = (tb.scene, tb.lights, tb.light_inst, tb.points, tb.cam)
    return torch.cat([t.reshape(-1).to(torch.float32) for t in parts]).contiguous()


def direct_tables(tb: LoopTables) -> torch.Tensor:
    """The direct kernels' tables: pack_tables', and where tb.light_rows is
    set (loop_params' emit_first) the light triangles' scene-row ids after
    them, as the bits of int32 in float32 (direct_step.cuh light_rows_of),
    read once a light hit and never copied to shared memory."""
    tables = pack_tables(tb)
    if tb.light_rows is None:
        return tables
    rows = tb.light_rows.to(device=tables.device, dtype=torch.int32).view(torch.float32)
    return torch.cat([tables, rows]).contiguous()


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
    """Raise NotImplementedError unless the dense route's shared-memory copy
    of the tables (n_floats in all, of which n_tris triangle rows of
    SCENE_COLS) fits a block: the path-loop kernels copy the tables whole,
    the direct kernels and trace_interact with triangle rows of GEOM_COLS
    (direct_step.cuh compact_size). The BVH route has no such limit."""
    cols = SCENE_COLS if integrator == "path" else GEOM_COLS
    if (n_floats - n_tris * (SCENE_COLS - cols)) * 4 > MAX_TABLE_BYTES:
        most = (MAX_TABLE_BYTES // 4 - (n_floats - n_tris * SCENE_COLS)) // cols
        raise NotImplementedError(
            f"{n_tris} triangles exceed the dense route of the {integrator} kernels, "
            f"whose tables must fit {MAX_TABLE_BYTES} bytes of shared memory: at most "
            f"{max(most, 0)} triangles with these lights; accel='auto' or 'bvh' walks the "
            "BVH, which has no such limit (ROADMAP A13)"
        )


def small_tables_shared(n_small: int) -> bool:
    """Whether a BVH instantiation copies the n_small floats of light,
    light-instance, point and camera rows into shared memory (they fit a
    block) or reads them from global memory."""
    return n_small * 4 <= MAX_TABLE_BYTES


def _loop_inputs(tb: LoopTables, lanes, material, n_steps, dev, integrator):
    """Check what the path-loop ("path") and direct ("direct") kernels read
    -> (N, packed tables, params; for a BVH route, whether the small tables
    go to shared memory)."""
    n = lanes.shape[1]
    _check(lanes, "lanes", torch.int32, (3, n), dev)
    if material.ndim != 3 or material.shape[2] != 4 or min(material.shape[:2]) < 2:
        raise ValueError(f"material must be (H >= 2, W >= 2, 4), got {tuple(material.shape)}")
    _check(material, "material", torch.float32, material.shape, dev)
    if material.data_ptr() % 16:
        raise ValueError("material must be 16-byte aligned for float4 loads")
    if tb.kind == "pmj02bn":
        _check(tb.bn, "blue noise", torch.float32, (tb.bn_res * tb.bn_res * tb.bn_ntex,), dev)
    tables = (direct_tables(tb) if integrator == "direct" else pack_tables(tb)).to(dev)
    # the floats a block may copy to shared memory: the light rows' ids of
    # direct_tables stay in global memory
    n_ids = tb.light_rows.numel() if integrator == "direct" and tb.light_rows is not None else 0
    n_floats = tables.numel() - n_ids
    n_tris = tb.scene.shape[0]
    if tb.bvh is None:
        check_table_fits(n_tris, n_floats, integrator)
    if n_steps < 0 or n >= 2**31:
        raise ValueError("n_steps must be >= 0 and N < 2**31")
    shared = small_tables_shared(n_floats - n_tris * SCENE_COLS)
    return n, tables, loop_params(tb, material), shared


def bvh_args(accel, dev) -> tuple:
    """Check an Accel's BVH -> the kernels' arguments nodes, geom, n_nodes,
    n_rows (csrc/trace.cuh Bvh)."""
    if not accel.is_bvh:
        raise ValueError(f"a BVH instantiation needs a 'bvh' Accel, got {accel.method!r}")
    m, rows = accel.nodes.shape[0], accel.geom.shape[0]
    _check(accel.nodes, "nodes", torch.float32, (m, NODE_COLS), dev)
    _check(accel.geom, "geom", torch.float32, (rows, GEOM_COLS), dev)
    if accel.geom.data_ptr() % 16 or accel.nodes.data_ptr() % 16:
        raise ValueError("the BVH's nodes and rows must be 16-byte aligned for float4 loads")
    if not (m or 0 < rows <= 1 << COUNT_BITS):
        raise ValueError(f"a BVH without internal nodes holds 1 to {1 << COUNT_BITS} rows, "
                         f"not {rows}")
    return accel.nodes.data_ptr(), accel.geom.data_ptr(), m, rows


def _counts(dev) -> torch.Tensor:
    """A kernel's work counter: ray-triangle tests, node visits."""
    return torch.zeros((2,), dtype=torch.int64, device=dev)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _bn_ptr(tb: LoopTables):
    return tb.bn.data_ptr() if tb.kind == "pmj02bn" else None


def _carry_out(carry: Carry, n: int, dev):
    """Check a carry -> the outputs of a launch that steps it."""
    _check(carry.f, "carry.f", torch.float32, (len(F_NAMES), n), dev)
    _check(carry.i, "carry.i", torch.int32, (len(I_NAMES), n), dev)
    return torch.empty_like(carry.f), torch.empty_like(carry.i)


# what a forward launch reports of its plan (path_loop.cu's launch)
LOOP_PLAN = ("block", "max_block", "registers", "local_bytes", "blocks_per_sm", "sms",
             "blocks", "rounds")


def loop_launch(lib, tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                carry: Carry, n_steps: int, block: int = 0):
    """One launch of a build of csrc/path_loop.cu (`lib`: load_library()'s
    entries, or a build's of the same C entries), its dense or its BVH
    kernel as tb.bvh says, under tb.env where the tables carry one (the env
    instantiations), on CUDA tensors, counting nothing: the forward
    wrappers, and the tests and studies of other blocks. block: threads a
    block, a power of two from 32 up to the kernel's largest (0: the
    launch's pick, the fewest rounds of resident blocks, then the largest
    block that gives every SM a block) -> (the new carry, counts (the BVH
    kernel's) or None, the launch's plan: LOOP_PLAN's fields, and the
    waves, lanes over resident threads)."""
    dev = lanes.device
    n, tables, params, shared = _loop_inputs(tb, lanes, material, n_steps, dev, "path")
    f_out, i_out = _carry_out(carry, n, dev)
    info = (ctypes.c_int * len(LOOP_PLAN))()
    bvh = tb.bvh is not None
    args = (params, tables.data_ptr(), tables.numel()) + ((int(shared),) if bvh else ()) + (
        _bn_ptr(tb), material.data_ptr(), lanes.data_ptr(), carry.f.data_ptr(),
        carry.i.data_ptr(), f_out.data_ptr(), i_out.data_ptr(), n, n_steps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    env = () if tb.env is None else env_args(tb.env, dev)
    counts = None
    if bvh:
        counts = _counts(dev)
        entry = lib.zdr_path_loop_env_bvh if env else lib.zdr_path_loop_bvh
        rc = entry(*args, *bvh_args(tb.bvh, dev), counts.data_ptr(), *env, block, info, stream)
    else:
        entry = lib.zdr_path_loop_env if env else lib.zdr_path_loop
        rc = entry(*args, *env, block, info, stream)
    _raise_on(rc, _loop_name("path_loop", tb))
    plan = dict(zip(LOOP_PLAN, info))
    plan["waves"] = n / (plan["block"] * plan["blocks_per_sm"] * plan["sms"])
    return Carry(f_out, i_out), counts, plan


def _loop_name(base: str, tb: LoopTables) -> str:
    """The path-loop kernel of the tables' route: base, _env, _bvh."""
    return base + ("_env" if tb.env is not None else "") + ("_bvh" if tb.bvh is not None else "")


def path_loop(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
              carry: Carry, n_steps: int) -> Carry:
    """Run every lane of `carry` for up to n_steps steps -> the new carry.
    lanes: (3, N) int32 px, py, stop; material: (H, W, 4). With a BVH in
    the tables, path_loop_bvh runs, with an env path_loop_env (or
    path_loop_env_bvh). `.plan` holds the last launch's block, registers,
    occupancy and waves.

    On the card a lane stops once its samples are done; the plain version
    idles it, which changes only its sampler state (acc_* and sample_idx
    agree)."""
    dev = lanes.device
    if not _on_card(dev, "path_loop"):
        return render_path_loop_plain(tb, lanes, material, carry, n_steps)
    if tb.env is not None:
        return path_loop_env(tb, lanes, material, carry, n_steps)
    if tb.bvh is not None:
        return path_loop_bvh(tb, lanes, material, carry, n_steps)
    out, _c, path_loop.plan = loop_launch(load_library(), tb, lanes, material, carry, n_steps)
    path_loop.launches += 1
    return out


path_loop.launches = 0
path_loop.plan = None


def path_loop_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                  carry: Carry, n_steps: int) -> Carry:
    """path_loop through the BVH of tb.bvh (the plain version the same:
    render_path_loop_plain walks the BVH the tables carry)."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_bvh"):
        return render_path_loop_plain(tb, lanes, material, carry, n_steps)
    if tb.env is not None:
        return path_loop_env_bvh(tb, lanes, material, carry, n_steps)
    out, path_loop_bvh.counts, path_loop_bvh.plan = loop_launch(
        load_library(), tb, lanes, material, carry, n_steps)
    path_loop_bvh.launches += 1
    return out


path_loop_bvh.launches = 0
path_loop_bvh.counts = None
path_loop_bvh.plan = None


def path_loop_env(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                  carry: Carry, n_steps: int) -> Carry:
    """path_loop under the environment light of tb.env: the dense kernel's
    env instantiation, or with a BVH in the tables path_loop_env_bvh (the
    plain version the same: loop_step reads the env the tables carry)."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_env"):
        return render_path_loop_plain(tb, lanes, material, carry, n_steps)
    if tb.env is None:
        raise ValueError("path_loop_env needs tables with an env")
    if tb.bvh is not None:
        return path_loop_env_bvh(tb, lanes, material, carry, n_steps)
    out, _c, path_loop_env.plan = loop_launch(load_library(), tb, lanes, material, carry,
                                              n_steps)
    path_loop_env.launches += 1
    return out


path_loop_env.launches = 0
path_loop_env.plan = None


def path_loop_env_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                      carry: Carry, n_steps: int) -> Carry:
    """path_loop_env through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_env_bvh"):
        return render_path_loop_plain(tb, lanes, material, carry, n_steps)
    if tb.env is None or tb.bvh is None:
        raise ValueError("path_loop_env_bvh needs tables with an env and a BVH")
    out, path_loop_env_bvh.counts, path_loop_env_bvh.plan = loop_launch(
        load_library(), tb, lanes, material, carry, n_steps)
    path_loop_env_bvh.launches += 1
    return out


path_loop_env_bvh.launches = 0
path_loop_env_bvh.counts = None
path_loop_env_bvh.plan = None


def grad_launch(lib, tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                le_grad: torch.Tensor, n_steps: int, k_cap=None):
    """One launch of a build of csrc/path_loop_grad.cu (`lib`: load_library()'s
    entries, or a build's of the same C entries), its dense or its BVH
    kernel as tb.bvh says, under tb.env where the tables carry one, on CUDA
    tensors, counting nothing: the gradient
    wrappers, and the tests and studies of other row layouts. k_cap: the
    most tap rows a sample in shared memory (GRAD_NEAR_ROWS of the route;
    0 keeps them all in global scratch) -> (d_material, the final carry,
    counts (the BVH kernel's) or None, the launch's plan). The kMerge
    instantiation where tb.splat_merge passes 1; packed_splat's rounding is
    the wrappers' (_packed_grad), not this launch's."""
    dev = lanes.device
    n, tables, params, shared = _loop_inputs(tb, lanes, material, n_steps, dev, "path")
    _check(le_grad, "le_grad", torch.float32, (3, n), dev)
    bvh = tb.bvh is not None
    # what the kernel keeps in shared memory before the rows: the dense
    # tables, or the BVH kernel's small tables where they fit
    n_small = tables.numel() - tb.scene.shape[0] * SCENE_COLS
    table_bytes = 4 * (n_small if shared else 0) if bvh else 4 * tables.numel()
    # the rows of a sample: one a step, max_depth at most
    rows = max(tb.max_depth, 1)
    k_cap = min(GRAD_NEAR_ROWS["bvh" if bvh else "dense"] if k_cap is None else k_cap, rows)
    info = (ctypes.c_int * 6)()
    name = _loop_name("path_loop_grad", tb)
    _raise_on(lib.zdr_path_loop_grad_plan(params, int(bvh), table_bytes, k_cap, info), name)
    plan = dict(zip(("k_near", "block", "registers", "blocks_per_sm", "smem_bytes",
                     "local_bytes"), info))
    carry = init_carry(lanes)
    f_out, i_out = torch.empty_like(carry.f), torch.empty_like(carry.i)
    planes = GRAD_ROW_PLANES + (1 if tb.splat_merge > 1 else 0)
    far = torch.empty((rows - plan["k_near"], planes, n), dtype=torch.float32, device=dev)
    grad = _tap_grad(material)
    args = (params, tables.data_ptr(), tables.numel()) + ((int(shared),) if bvh else ()) + (
        _bn_ptr(tb), material.data_ptr(), lanes.data_ptr(), le_grad.data_ptr(),
        carry.f.data_ptr(), carry.i.data_ptr(), f_out.data_ptr(), i_out.data_ptr(),
        far.data_ptr(), grad.data_ptr(), n, n_steps, plan["k_near"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    env = () if tb.env is None else env_args(tb.env, dev)
    counts = None
    if bvh:
        counts = _counts(dev)
        entry = lib.zdr_path_loop_grad_env_bvh if env else lib.zdr_path_loop_grad_bvh
        rc = entry(*args, *bvh_args(tb.bvh, dev), counts.data_ptr(), *env, stream)
    else:
        entry = lib.zdr_path_loop_grad_env if env else lib.zdr_path_loop_grad
        rc = entry(*args, *env, stream)
    _raise_on(rc, name)
    return grad, Carry(f_out, i_out), counts, plan


def splat_round(grad: torch.Tensor, scratch=None) -> torch.Tensor:
    """The packed splat's bf16 rounding (csrc/splat.cu): with scratch None,
    grad's values rounded to bf16 in place; else grad += bf16(scratch) and
    scratch zeroed. Both float32 tensors of the same shape, their size a
    multiple of 4 -> grad. On the CPU the plain version, texture.round_bf16,
    does the same in place."""
    dev = grad.device
    if scratch is not None:
        _check(scratch, "scratch", torch.float32, grad.shape, dev)
    if not _on_card(dev, "splat_round"):
        if scratch is None:
            grad.copy_(round_bf16(grad))
        else:
            grad += round_bf16(scratch)
            scratch.zero_()
        return grad
    _check(grad, "grad", torch.float32, grad.shape, dev)
    for t in (grad, scratch):
        if t is not None and (t.data_ptr() % 16 or t.numel() % 4):
            raise ValueError("splat_round takes 16-byte aligned tensors of whole float4s")
    rc = load_library().zdr_splat_round(
        grad.data_ptr(), None if scratch is None else scratch.data_ptr(), grad.numel(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "splat_round")
    splat_round.launches += 1
    return grad


splat_round.launches = 0


def _packed_grad(tb: LoopTables, grad: torch.Tensor) -> torch.Tensor:
    """The path gradient kernels' epilogue: with packed_splat every texel
    rounded to bf16 (splat_round), the JAX loop route's one rounded flush
    of the totals (pallas_loop.py:1254-1258)."""
    return splat_round(grad) if tb.packed_splat else grad


def _acc(tb: LoopTables, n: int, le_grad, dev) -> torch.Tensor:
    """The (3, n) radiance sums of a direct or collocated launch, le_grad
    checked: zeroed for packed_splat's tap mode, whose launches each add
    their group's radiance to the sums before them."""
    if le_grad is None:
        return torch.empty((3, n), dtype=torch.float32, device=dev)
    _check(le_grad, "le_grad", torch.float32, (3, n), dev)
    alloc = torch.zeros if tb.packed_splat else torch.empty
    return alloc((3, n), dtype=torch.float32, device=dev)


def _launches(tb: LoopTables, material, le_grad, launch):
    """The direct and collocated kernels' launches, launch(params, target):
    the forward (le_grad None) once with no gradient; the tap mode once into
    a zeroed gradient, or with packed_splat once a group of SPLAT_BATCH
    samples, the params' first sample the group's, into a zeroed scratch
    that splat_round rounds into the gradient after each (the JAX package's
    flush every SCATTER_BATCH samples, direct_fused.py:328-345) -> (the
    gradient or None, the launches)."""
    if le_grad is None:
        launch(loop_params(tb, material), None)
        return None, 1
    grad = _tap_grad(material)
    if not tb.packed_splat:
        launch(loop_params(tb, material), grad)
        return grad, 1
    scratch = _tap_grad(material)
    firsts = range(0, tb.spp, SPLAT_BATCH)
    for first in firsts:
        launch(loop_params(tb, material, first), scratch)
        splat_round(grad, scratch)
    return grad, len(firsts)


def path_loop_grad(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                   le_grad: torch.Tensor, n_steps: int):
    """PRB texture gradient of every lane's samples, walked from the first
    carry, given le_grad, the (3, N) float32 adjoint of each of a lane's
    samples -> (d_material (H, W, 4), the final carry, whose acc_* rows are
    the forward render's). With a BVH in the tables, path_loop_grad_bvh
    runs, with an env path_loop_grad_env (or path_loop_grad_env_bvh).
    `.plan` holds the last launch's tap rows in shared memory, block,
    registers and occupancy.

    On the card the float atomics sum the taps in an order that changes
    from run to run, so the gradient's last bits do too."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_grad"):
        return render_path_backward_loop_plain(tb, lanes, material, le_grad, n_steps)
    if tb.env is not None:
        return path_loop_grad_env(tb, lanes, material, le_grad, n_steps)
    if tb.bvh is not None:
        return path_loop_grad_bvh(tb, lanes, material, le_grad, n_steps)
    grad, carry, _c, path_loop_grad.plan = grad_launch(load_library(), tb, lanes, material,
                                                       le_grad, n_steps)
    path_loop_grad.launches += 1
    return _packed_grad(tb, grad), carry


path_loop_grad.launches = 0
path_loop_grad.plan = None


def path_loop_grad_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                       le_grad: torch.Tensor, n_steps: int):
    """path_loop_grad through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_grad_bvh"):
        return render_path_backward_loop_plain(tb, lanes, material, le_grad, n_steps)
    if tb.env is not None:
        return path_loop_grad_env_bvh(tb, lanes, material, le_grad, n_steps)
    grad, carry, path_loop_grad_bvh.counts, path_loop_grad_bvh.plan = grad_launch(
        load_library(), tb, lanes, material, le_grad, n_steps)
    path_loop_grad_bvh.launches += 1
    return _packed_grad(tb, grad), carry


path_loop_grad_bvh.launches = 0
path_loop_grad_bvh.counts = None
path_loop_grad_bvh.plan = None


def path_loop_grad_env(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                       le_grad: torch.Tensor, n_steps: int):
    """path_loop_grad under the environment light of tb.env, as
    path_loop_env."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_grad_env"):
        return render_path_backward_loop_plain(tb, lanes, material, le_grad, n_steps)
    if tb.env is None:
        raise ValueError("path_loop_grad_env needs tables with an env")
    if tb.bvh is not None:
        return path_loop_grad_env_bvh(tb, lanes, material, le_grad, n_steps)
    grad, carry, _c, path_loop_grad_env.plan = grad_launch(load_library(), tb, lanes, material,
                                                           le_grad, n_steps)
    path_loop_grad_env.launches += 1
    return _packed_grad(tb, grad), carry


path_loop_grad_env.launches = 0
path_loop_grad_env.plan = None


def path_loop_grad_env_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                           le_grad: torch.Tensor, n_steps: int):
    """path_loop_grad_env through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "path_loop_grad_env_bvh"):
        return render_path_backward_loop_plain(tb, lanes, material, le_grad, n_steps)
    if tb.env is None or tb.bvh is None:
        raise ValueError("path_loop_grad_env_bvh needs tables with an env and a BVH")
    grad, carry, path_loop_grad_env_bvh.counts, path_loop_grad_env_bvh.plan = grad_launch(
        load_library(), tb, lanes, material, le_grad, n_steps)
    path_loop_grad_env_bvh.launches += 1
    return _packed_grad(tb, grad), carry


path_loop_grad_env_bvh.launches = 0
path_loop_grad_env_bvh.counts = None
path_loop_grad_env_bvh.plan = None


def sampler_probe(kind: str, spp: int, lanes: torch.Tensor, k: int, bn) -> torch.Tensor:
    """(3k, N) draws of a fresh sampler per lane: for each j, next1 then
    next2's x and y. lanes: (4, N) int32 px, py, seed, sample_idx;
    bn = (rows, res, n_tex) blue noise on the same device (pmj02bn)."""
    dev = lanes.device
    if not _on_card(dev, "sampler_probe"):
        return sampler_probe_plain(kind, spp, lanes, k, bn)
    n = lanes.shape[1]
    _check(lanes, "lanes", torch.int32, (4, n), dev)
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


def env_args(env, dev) -> tuple:
    """Check an EnvMap's tensors -> the env entries' arguments texture, h,
    w, alias probabilities, alias indices, pdf (path_loop_step.cuh
    EnvTables): read through the read-only path, the texture by float4."""
    h, w = env.texture.shape[0], env.texture.shape[1]
    if h < 2:
        raise ValueError(f"an envmap needs 2 rows or more, got {h}")
    n_alias = SAMPLE_MAP_H + SAMPLE_MAP_H * SAMPLE_MAP_W
    _check(env.texture, "env texture", torch.float32, (h, w, 4), dev)
    _check(env.alias_prob, "env alias_prob", torch.float32, (n_alias,), dev)
    _check(env.alias_idx, "env alias_idx", torch.int32, (n_alias,), dev)
    _check(env.pdf, "env pdf", torch.float32, (SAMPLE_MAP_H * SAMPLE_MAP_W,), dev)
    if env.texture.data_ptr() % 16:
        raise ValueError("the env texture must be 16-byte aligned for float4 loads")
    return (env.texture.data_ptr(), h, w, env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
            env.pdf.data_ptr())


def direct_early(n_tris: int) -> bool:
    """Whether the dense direct kernels sweep a scene of n_tris triangles
    with the early out (csrc/direct_step.cuh CompactSweep<true>) rather
    than without it: where accel="auto" would walk the BVH, from
    accel/build.DENSE_MAX_TRIS["direct"] triangles on, so only a forced
    dense route takes it. The early out's bounds cost more than the tests
    they skip on the dense route's own scenes and pay past them
    (studies/direct_split.py; PERF.md)."""
    return n_tris >= DENSE_MAX_TRIS["direct"]


def direct_launch(lib, tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                  le_grad=None, block: int = 0, early=None):
    """One launch of a build of csrc/direct.cu's dense kernel (`lib`:
    load_library()'s entries, or a build's of the same C entry), forward
    (le_grad None) or tap mode, under tb.env where the tables carry one (the
    env instantiations), on CUDA tensors, counting nothing: the
    direct wrappers, and the tests and studies of other blocks and sweeps.
    block: threads a block, a power of two from 32 up to the kernel's
    largest (0: the launch's pick, as loop_launch's); early: the sweeps
    with the early out or without (None: direct_early's rule) ->
    (grad or None, acc, counts, the launch's plan: LOOP_PLAN's fields, the
    waves, early and the launches: one, or with packed_splat in tap mode
    one a group of SPLAT_BATCH samples, _launches)."""
    dev = lanes.device
    if early is None:
        early = direct_early(tb.scene.shape[0])
    n, tables, _params, _shared = _loop_inputs(tb, lanes, material, 0, dev, "direct")
    acc = _acc(tb, n, le_grad, dev)
    counts = _counts(dev)
    info = (ctypes.c_int * len(LOOP_PLAN))()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = ("direct" if le_grad is None else "direct_grad") + ("_env" if tb.env else "")
    env = () if tb.env is None else env_args(tb.env, dev)
    entry = lib.zdr_direct_env if env else lib.zdr_direct

    def launch(params, target):
        rc = entry(params, tables.data_ptr(), tables.numel(), _bn_ptr(tb), material.data_ptr(),
                   lanes.data_ptr(), None if le_grad is None else le_grad.data_ptr(),
                   acc.data_ptr(), None if target is None else target.data_ptr(),
                   counts.data_ptr(), n, int(early), *env, block, info, stream)
        _raise_on(rc, name)

    grad, launches = _launches(tb, material, le_grad, launch)
    plan = dict(zip(LOOP_PLAN, info))
    plan["waves"] = n / (plan["block"] * plan["blocks_per_sm"] * plan["sms"])
    plan["early"] = bool(early)
    plan["launches"] = launches
    return grad, acc, counts, plan


def direct(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """Every lane's samples 0 .. stop-1 of the direct integrator -> the
    (3, N) float32 sums of their clamped radiances. lanes: (3, N) int32
    px, py, stop; material: (H, W, 4). With a BVH in the tables, direct_bvh
    runs, with an env direct_env (or direct_env_bvh). `.plan` holds the last
    launch's block, registers, occupancy and waves."""
    dev = lanes.device
    if not _on_card(dev, "direct"):
        return render_direct_plain(tb, lanes, material)
    if tb.env is not None:
        return direct_env(tb, lanes, material)
    if tb.bvh is not None:
        return direct_bvh(tb, lanes, material)
    _g, acc, counts, direct.plan = direct_launch(load_library(), tb, lanes, material)
    direct.launches += 1
    direct.tests, direct.visits = counts[0], counts[1]
    return acc


direct.launches = 0
direct.tests = direct.visits = None
direct.plan = None


def direct_grad(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                le_grad: torch.Tensor):
    """Texture gradient of every lane's direct samples, given le_grad, the
    (3, N) float32 adjoint of each of a lane's samples -> (d_material
    (H, W, 4), the (3, N) radiance sums of the same samples, as direct's).
    With a BVH in the tables, direct_grad_bvh runs, with an env
    direct_grad_env (or direct_grad_env_bvh). `.plan` as direct's.

    On the card each tap is one float4 atomic; the atomics sum the taps in
    an order that changes from run to run, so the gradient's last bits do
    too."""
    dev = lanes.device
    if not _on_card(dev, "direct_grad"):
        return render_direct_backward_plain(tb, lanes, material, le_grad)
    if tb.env is not None:
        return direct_grad_env(tb, lanes, material, le_grad)
    if tb.bvh is not None:
        return direct_grad_bvh(tb, lanes, material, le_grad)
    grad, acc, counts, direct_grad.plan = direct_launch(load_library(), tb, lanes, material,
                                                        le_grad)
    direct_grad.launches += direct_grad.plan["launches"]
    direct_grad.tests, direct_grad.visits = counts[0], counts[1]
    return grad, acc


direct_grad.launches = 0
direct_grad.tests = direct_grad.visits = None
direct_grad.plan = None


def _tap_grad(material):
    """A zeroed gradient of `material`'s shape for a tap kernel's vector
    atomics (one float4 a texel), checked 16-byte aligned."""
    grad = torch.zeros_like(material)
    if grad.data_ptr() % 16:
        raise ValueError("the gradient must be 16-byte aligned for vector atomics")
    return grad


def _bvh_launches(tb, lanes, material, le_grad, dev, integrator):
    """The launches of zdr_direct_bvh (zdr_direct_env_bvh under tb.env) or
    zdr_collocated_bvh, forward (le_grad None) or tap mode, packed as
    _launches says -> (grad or None, acc, counts, launches)."""
    n, tables, _params, shared = _loop_inputs(tb, lanes, material, 0, dev, integrator)
    acc = _acc(tb, n, le_grad, dev)
    counts = _counts(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = load_library()
    # the collocated kernels take no env
    env = () if tb.env is None or integrator == "collocated" else env_args(tb.env, dev)
    if integrator == "collocated":
        entry = lib.zdr_collocated_bvh
    else:
        entry = lib.zdr_direct_env_bvh if env else lib.zdr_direct_bvh
    name = (integrator + ("" if le_grad is None else "_grad") + ("_env" if env else "")
            + "_bvh")

    def launch(params, target):
        rc = entry(params, tables.data_ptr(), tables.numel(), int(shared), _bn_ptr(tb),
                   material.data_ptr(), lanes.data_ptr(),
                   None if le_grad is None else le_grad.data_ptr(), acc.data_ptr(),
                   None if target is None else target.data_ptr(), *bvh_args(tb.bvh, dev),
                   counts.data_ptr(), n, *env, stream)
        _raise_on(rc, name)

    grad, launches = _launches(tb, material, le_grad, launch)
    return grad, acc, counts, launches


def direct_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """direct through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "direct_bvh"):
        return render_direct_plain(tb, lanes, material)
    _grad, acc, counts, _k = _bvh_launches(tb, lanes, material, None, dev, "direct")
    direct_bvh.launches += 1
    direct_bvh.counts = counts
    return acc


direct_bvh.launches = 0
direct_bvh.counts = None


def direct_grad_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                    le_grad: torch.Tensor):
    """direct_grad through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "direct_grad_bvh"):
        return render_direct_backward_plain(tb, lanes, material, le_grad)
    grad, acc, counts, k = _bvh_launches(tb, lanes, material, le_grad, dev, "direct")
    direct_grad_bvh.launches += k
    direct_grad_bvh.counts = counts
    return grad, acc


direct_grad_bvh.launches = 0
direct_grad_bvh.counts = None


def direct_env(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """direct under the environment light of tb.env: the dense kernel's env
    instantiation, or with a BVH in the tables direct_env_bvh (the plain
    version the same: render_direct_plain reads the env the tables carry)."""
    dev = lanes.device
    if not _on_card(dev, "direct_env"):
        return render_direct_plain(tb, lanes, material)
    if tb.env is None:
        raise ValueError("direct_env needs tables with an env")
    if tb.bvh is not None:
        return direct_env_bvh(tb, lanes, material)
    _g, acc, counts, direct_env.plan = direct_launch(load_library(), tb, lanes, material)
    direct_env.launches += 1
    direct_env.tests, direct_env.visits = counts[0], counts[1]
    return acc


direct_env.launches = 0
direct_env.tests = direct_env.visits = None
direct_env.plan = None


def direct_grad_env(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                    le_grad: torch.Tensor):
    """direct_grad under the environment light of tb.env, as direct_env."""
    dev = lanes.device
    if not _on_card(dev, "direct_grad_env"):
        return render_direct_backward_plain(tb, lanes, material, le_grad)
    if tb.env is None:
        raise ValueError("direct_grad_env needs tables with an env")
    if tb.bvh is not None:
        return direct_grad_env_bvh(tb, lanes, material, le_grad)
    grad, acc, counts, direct_grad_env.plan = direct_launch(load_library(), tb, lanes,
                                                            material, le_grad)
    direct_grad_env.launches += direct_grad_env.plan["launches"]
    direct_grad_env.tests, direct_grad_env.visits = counts[0], counts[1]
    return grad, acc


direct_grad_env.launches = 0
direct_grad_env.tests = direct_grad_env.visits = None
direct_grad_env.plan = None


def direct_env_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """direct_env through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "direct_env_bvh"):
        return render_direct_plain(tb, lanes, material)
    _grad, acc, counts, _k = _bvh_launches(tb, lanes, material, None, dev, "direct")
    direct_env_bvh.launches += 1
    direct_env_bvh.counts = counts
    return acc


direct_env_bvh.launches = 0
direct_env_bvh.counts = None


def direct_grad_env_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                        le_grad: torch.Tensor):
    """direct_grad_env through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "direct_grad_env_bvh"):
        return render_direct_backward_plain(tb, lanes, material, le_grad)
    grad, acc, counts, k = _bvh_launches(tb, lanes, material, le_grad, dev, "direct")
    direct_grad_env_bvh.launches += k
    direct_grad_env_bvh.counts = counts
    return grad, acc


direct_grad_env_bvh.launches = 0
direct_grad_env_bvh.counts = None


def _collocated_launch(tb, lanes, material, le_grad, dev):
    """The launches of zdr_collocated, forward (le_grad None) or tap mode
    (packed as _launches says), at the block the launch picks -> (grad
    or None, acc, counts, the launch's plan: LOOP_PLAN's fields, the waves
    and the launches)."""
    n, tables, _params, _shared = _loop_inputs(tb, lanes, material, 0, dev, "collocated")
    acc = _acc(tb, n, le_grad, dev)
    counts = _counts(dev)
    info = (ctypes.c_int * len(LOOP_PLAN))()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(params, target):
        rc = load_library().zdr_collocated(
            params, tables.data_ptr(), tables.numel(), _bn_ptr(tb), material.data_ptr(),
            lanes.data_ptr(), None if le_grad is None else le_grad.data_ptr(), acc.data_ptr(),
            None if target is None else target.data_ptr(), counts.data_ptr(), n, 0, info,
            stream)
        _raise_on(rc, "collocated" if le_grad is None else "collocated_grad")

    grad, launches = _launches(tb, material, le_grad, launch)
    plan = dict(zip(LOOP_PLAN, info))
    plan["waves"] = n / (plan["block"] * plan["blocks_per_sm"] * plan["sms"])
    plan["launches"] = launches
    return grad, acc, counts, plan


def collocated(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """Every lane's samples 0 .. stop-1 of the collocated integrator -> the
    (3, N) float32 sums of their clamped radiances. lanes: (3, N) int32 px,
    py, stop; material: (H, W, 4). With a BVH in the tables,
    collocated_bvh runs. `.plan` holds the last launch's block, registers,
    occupancy and waves; `.tests` its ray-triangle tests."""
    dev = lanes.device
    if not _on_card(dev, "collocated"):
        return render_collocated_plain(tb, lanes, material)
    if tb.bvh is not None:
        return collocated_bvh(tb, lanes, material)
    _g, acc, counts, collocated.plan = _collocated_launch(tb, lanes, material, None, dev)
    collocated.launches += 1
    collocated.tests = counts[0]
    return acc


collocated.launches = 0
collocated.tests = None
collocated.plan = None


def collocated_grad(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                    le_grad: torch.Tensor):
    """Texture gradient of every lane's collocated samples, given le_grad,
    the (3, N) float32 adjoint of each of a lane's samples -> (d_material
    (H, W, 4), the (3, N) radiance sums of the same samples). With a BVH in
    the tables, collocated_grad_bvh runs. `.plan` as collocated's.

    On the card each tap is one float4 atomic, summed in an order that
    changes from run to run."""
    dev = lanes.device
    if not _on_card(dev, "collocated_grad"):
        return render_collocated_backward_plain(tb, lanes, material, le_grad)
    if tb.bvh is not None:
        return collocated_grad_bvh(tb, lanes, material, le_grad)
    grad, acc, counts, collocated_grad.plan = _collocated_launch(tb, lanes, material, le_grad,
                                                                 dev)
    collocated_grad.launches += collocated_grad.plan["launches"]
    collocated_grad.tests = counts[0]
    return grad, acc


collocated_grad.launches = 0
collocated_grad.tests = None
collocated_grad.plan = None


def collocated_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor) -> torch.Tensor:
    """collocated through the BVH of tb.bvh; `.counts`: tests, node visits."""
    dev = lanes.device
    if not _on_card(dev, "collocated_bvh"):
        return render_collocated_plain(tb, lanes, material)
    _grad, acc, counts, _k = _bvh_launches(tb, lanes, material, None, dev, "collocated")
    collocated_bvh.launches += 1
    collocated_bvh.counts = counts
    return acc


collocated_bvh.launches = 0
collocated_bvh.counts = None


def collocated_grad_bvh(tb: LoopTables, lanes: torch.Tensor, material: torch.Tensor,
                        le_grad: torch.Tensor):
    """collocated_grad through the BVH of tb.bvh."""
    dev = lanes.device
    if not _on_card(dev, "collocated_grad_bvh"):
        return render_collocated_backward_plain(tb, lanes, material, le_grad)
    grad, acc, counts, k = _bvh_launches(tb, lanes, material, le_grad, dev, "collocated")
    collocated_grad_bvh.launches += k
    collocated_grad_bvh.counts = counts
    return grad, acc


collocated_grad_bvh.launches = 0
collocated_grad_bvh.counts = None


def _trace_inputs(accel, o, d, t_min, t_max):
    """Check a trace's rays -> (n, dev, t_min and t_max as (n,) float32,
    the mode's arguments bvh_mode (0: dense, 1: the BVH), geom, n_rows,
    nodes, n_nodes)."""
    n, dev = o.shape[0], o.device
    _check(o, "o", torch.float32, (n, 3), dev)
    _check(d, "d", torch.float32, (n, 3), dev)
    t_lo = torch.broadcast_to(torch.as_tensor(t_min, dtype=torch.float32, device=dev),
                              (n,)).contiguous()
    t_hi = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                              (n,)).contiguous()
    if n >= 2**31:
        raise ValueError("N < 2**31")
    if accel.is_bvh:
        nodes, geom, m, rows = bvh_args(accel, dev)
        mode = (1, geom, rows, nodes, m)
    else:
        _check(accel.geom, "geom", torch.float32, (accel.geom.shape[0], GEOM_COLS), dev)
        if accel.geom.data_ptr() % 16:
            raise ValueError("the geometry rows must be 16-byte aligned for float4 loads")
        mode = (0, accel.geom.data_ptr(), accel.geom.shape[0], None, 0)
    return n, dev, t_lo, t_hi, mode


def trace_closest(accel, o: torch.Tensor, d: torch.Tensor, t_min=0.0, t_max=1e30):
    """Closest hit of (N, 3) float32 rays at t in (t_min, t_max), scalars or
    (N,), through the accel's dense rows or its BVH -> (t (t_max on a miss),
    prim int32 global id (-1), u, v float32 (0 on a miss))."""
    if not _on_card(o.device, "trace_closest"):
        out, _work = trace_closest_plain(accel, o, d, t_min, t_max)
        return out
    n, dev, t_lo, t_hi, mode = _trace_inputs(accel, o, d, t_min, t_max)
    t, u, v = (torch.empty((n,), dtype=torch.float32, device=dev) for _ in range(3))
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = _counts(dev)
    rc = load_library().zdr_trace_closest(
        *mode, o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), t.data_ptr(),
        u.data_ptr(), v.data_ptr(), prim.data_ptr(), counts.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "trace_closest")
    trace_closest.launches += 1
    trace_closest.counts = counts
    return t, prim, u, v


trace_closest.launches = 0
trace_closest.counts = None


def trace_any(accel, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=1e30) -> torch.Tensor:
    """Any hit of (N, 3) float32 rays at t in (t_min, t_max), scalars or
    (N,) -> (N,) bool."""
    if not _on_card(o.device, "trace_any"):
        occ, _work = trace_any_plain(accel, o, d, t_min, t_max)
        return occ
    n, dev, t_lo, t_hi, mode = _trace_inputs(accel, o, d, t_min, t_max)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = _counts(dev)
    rc = load_library().zdr_trace_any(
        *mode, o.data_ptr(), d.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), occ.data_ptr(),
        counts.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "trace_any")
    trace_any.launches += 1
    trace_any.counts = counts
    return occ != 0


trace_any.launches = 0
trace_any.counts = None


# -------------------------------------------------------- the sweep variants

# f_out and i_out planes of each mode (csrc/sweep_variants.cu)
_VARIANT_PLANES = {"closest": (3, 1), "any": (0, 1), "interact": (14, 2), "lite": (3, 1)}


def variant_outputs(mode: str, f_out: torch.Tensor, i_out: torch.Tensor):
    """A sweep variant's output planes -> its plain version's outputs."""
    if mode == "closest":
        return f_out[0], i_out[0], f_out[1], f_out[2]
    if mode == "any":
        return i_out[0] != 0
    if mode == "lite":
        return (*f_out.unbind(0), i_out[0])
    f, i = f_out.unbind(0), i_out.unbind(0)
    return (*f[0:11], i[0], *f[11:14], i[1])


def _variant(name, mode, tile, r, woop, cull, rows, geom, table, boxes, rays, active):
    """Check a sweep variant's inputs, launch it -> (its outputs, counts)."""
    dev = rays.device
    if mode not in MODES:
        raise ValueError(f"{name}: unknown sweep mode {mode!r}")
    n, n_tris = rays.shape[1], rows.shape[0]
    _check(rays, "rays", torch.float32, (8, n), dev)
    _check(active, "active", torch.int32, (n,), dev)
    for t, what in ((rows, "rows"), (geom, "geom")):
        _check(t, what, torch.float32, (n_tris, GEOM_COLS), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned for float4 loads")
    if mode in ("interact", "lite"):
        _check(table, "table", torch.float32, (n_tris, SCENE_COLS), dev)
    if cull:
        _check(boxes, "boxes", torch.float32, (-(-n_tris // tile), 6), dev)
    if n >= 2**31:
        raise ValueError("N < 2**31")
    n_f, n_i = _VARIANT_PLANES[mode]
    f_out = torch.empty((n_f, n), dtype=torch.float32, device=dev)
    i_out = torch.empty((n_i, n), dtype=torch.int32, device=dev)
    counts = _counts(dev)
    rc = load_library().zdr_sweep_variant(
        MODES.index(mode), tile, r, int(woop), int(cull), rows.data_ptr(), geom.data_ptr(),
        None if table is None else table.data_ptr(), None if boxes is None else boxes.data_ptr(),
        n_tris, rays.data_ptr(), active.data_ptr(), f_out.data_ptr(), i_out.data_ptr(),
        counts.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if rc == 1:  # cudaErrorInvalidValue
        raise ValueError(f"{name}: ({mode}, kTile {tile}, R {r}, woop {woop}, cull {cull}) "
                         "is no grid point of csrc/sweep_variants.cu (or a bad launch)")
    _raise_on(rc, name)
    return variant_outputs(mode, f_out, i_out), counts


def sweep_variant(geom: torch.Tensor, table: torch.Tensor, rays: torch.Tensor,
                  active: torch.Tensor, mode: str, tile: int = 512, r: int = 1):
    """The dense Möller–Trumbore sweep of rays (8, N) (o3 d3 pdf_prev t_max)
    over geom (T, 12), kTile `tile` rows a shared-memory tile and `r` rays a
    thread, in `mode` (closest, any, interact, lite; table (T, 31) for the
    last two) -> accel/variants.sweep_variant_plain's outputs."""
    if not _on_card(rays.device, "sweep_variant"):
        return sweep_variant_plain(geom, table, rays, active, mode)[0]
    out, sweep_variant.counts = _variant("sweep_variant", mode, tile, r, False, False, geom,
                                         geom, table, None, rays, active)
    sweep_variant.launches += 1
    return out


sweep_variant.launches = 0
sweep_variant.counts = None


def woop_sweep(woop: torch.Tensor, geom: torch.Tensor, table: torch.Tensor,
               rays: torch.Tensor, active: torch.Tensor, mode: str, tile: int = 512):
    """The dense sweep by the Woop test over woop (T, 12) rows
    (accel/woop.woop_rows), the winner re-derived from geom (T, 12) ->
    accel/variants.woop_sweep_plain's outputs."""
    if not _on_card(rays.device, "woop_sweep"):
        return woop_sweep_plain(woop, geom, table, rays, active, mode)[0]
    out, woop_sweep.counts = _variant("woop_sweep", mode, tile, 1, True, False, woop, geom,
                                      table, None, rays, active)
    woop_sweep.launches += 1
    return out


woop_sweep.launches = 0
woop_sweep.counts = None


def aabb_sweep(rows: torch.Tensor, geom: torch.Tensor, boxes: torch.Tensor, tile: int,
               rays: torch.Tensor, active: torch.Tensor, mode: str, woop: bool = False):
    """The sweep with per-tile box culls (boxes: accel/woop.tile_boxes(geom,
    tile)), closest or any hit, over geometry rows or with woop Woop rows ->
    accel/variants.aabb_sweep_plain's outputs; `.counts`: tests, box tests."""
    if not _on_card(rays.device, "aabb_sweep"):
        return aabb_sweep_plain(rows, geom, boxes, tile, rays, active, mode, woop)[0]
    if mode not in ("closest", "any"):
        raise ValueError(f"aabb_sweep runs closest or any hit, got {mode!r}")
    out, aabb_sweep.counts = _variant("aabb_sweep", mode, tile, 1, woop, True, rows, geom,
                                      None, boxes, rays, active)
    aabb_sweep.launches += 1
    return out


aabb_sweep.launches = 0
aabb_sweep.counts = None


def floor_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b over two (N,) float32 tensors, 16-byte aligned: an empty,
    kernel-shaped launch."""
    dev = a.device
    if not _on_card(dev, "floor_probe"):
        return floor_probe_plain(a, b)
    n = a.shape[0]
    _check(a, "a", torch.float32, (n,), dev)
    _check(b, "b", torch.float32, (n,), dev)
    out = torch.empty_like(a)
    if (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("floor_probe: a, b and out must be 16-byte aligned for float4 access")
    rc = load_library().zdr_floor_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "floor_probe")
    floor_probe.launches += 1
    return out


floor_probe.launches = 0
