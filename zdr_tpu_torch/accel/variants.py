"""The sweep variants' plain versions, and the rays they are measured on.

The TPU measurement kernels under tools/ (B9: profile_wide.py,
profile_sweep_variants.py, profile_mxu_variants.py, profile_chunk.py) took
apart the cost of the closest-hit sweep of B3/B4 on the reference
protocol's 962-triangle scene. Their H100 counterparts are the kernels of
kernels/csrc/sweep_variants.cu; these are their plain versions, each in the
kernel's operand order, so that the two agree bit for bit:

  sweep_variant_plain   the dense Möller–Trumbore sweep (accel/trace.py's)
                        in four modes: closest, any, and the closest hit
                        followed by trace_interact's full or lite epilogue
                        (integrators/bounce.py's); any kTile and rays a
                        thread give the same result;
  woop_sweep_plain      the same sweep by the Woop test over accel/woop.py's
                        rows, the winner re-derived by Möller–Trumbore;
  aabb_sweep_plain      closest or any hit, tile by tile in scene order, a
                        warp of 32 consecutive rays skipping a tile whose box
                        none of its open rays hits (MT or Woop tests);
  floor_probe_plain     a + b;
  leaf_accel            the BVH at another leaf width than production's,
                        for the trace kernels' leaf-width measurement.

Each takes rays as the (8, N) float32 planes o3 d3 pdf_prev t_max and an
(N,) int32 active row, and returns its outputs and its work: (ray-triangle
tests, box tests). Closest hit is at t in (0, t_max), any hit in
(1e-4, t_max); the epilogue modes sweep to 1e30, as trace_interact does.
Outputs: closest (t, prim, u, v) as the trace kernels' (t_max, -1, 0, 0 on
a miss); any the occlusion (bool); interact and lite trace_interact's 16 or
4 planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..camera import camera_ray
from ..integrators.bounce import interact_planes, trace_interact_plain
from ..integrators.path_loop import _fresh_state, _sampler, build_loop_tables, pixel_lanes
from ..vec import vnormalize, vsub
from .build import _vertices, pack_bvh
from .native import build_bvh_native
from .trace import _row_cols, aabb_hit, dense_any, dense_closest, mt, mt_rows, safe_inv

MODES = ("closest", "any", "interact", "lite")
WARP = 32  # the rays that decide a cull together (sweep_variants.cuh kWarp)
T_MIN_ANY = 1e-4
T_MAX = 1e30


def _rays(rays):
    o, d = tuple(rays[0:3]), tuple(rays[3:6])
    n = rays.shape[1]
    t_min = torch.zeros((n,), dtype=torch.float32, device=rays.device)
    return o, d, t_min


def _work(tests, boxes=0):
    return (torch.as_tensor(tests, dtype=torch.int64).cpu(),
            torch.as_tensor(boxes, dtype=torch.int64).cpu())


def woop_rows_test(w, o, d):
    """The Woop test of (N,) rays against every Woop row of `w` (T, 12) ->
    (N, T) planes (ok without the t range, u, v, t), in woop_hit's order."""
    c = [w[:, k][None, :] for k in range(12)]
    o = tuple(x[:, None] for x in o)
    d = tuple(x[:, None] for x in d)
    ow = c[8] * o[0] + c[9] * o[1] + c[10] * o[2] + c[11]
    dw = c[8] * d[0] + c[9] * d[1] + c[10] * d[2]
    t = -ow / dw
    ou = c[0] * o[0] + c[1] * o[1] + c[2] * o[2] + c[3]
    du = c[0] * d[0] + c[1] * d[1] + c[2] * d[2]
    u = ou + t * du
    ov = c[4] * o[0] + c[5] * o[1] + c[6] * o[2] + c[7]
    dv = c[4] * d[0] + c[5] * d[1] + c[6] * d[2]
    v = ov + t * dv
    ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return ok, u, v, t


def _rederive(geom, o, d, hit):
    """The winner's t, u, v by Möller–Trumbore from its geometry row
    (pallas_bounce.py::_mt_rederive, :810-828) -> the hit with them; a miss
    keeps (t_max, -1, 0, 0)."""
    t, prim, u, v = hit
    found = prim >= 0
    _ok, u2, v2, t2 = mt(*_row_cols(geom, torch.clamp_min(prim, 0).long()), o, d)
    return (torch.where(found, t2, t), prim, torch.where(found, u2, u),
            torch.where(found, v2, v))


def sweep_variant_plain(geom, table, rays, active, mode):
    """The plain version of the sweep_variant kernel at any kTile and R.
    geom (T, 12) geometry rows, table (T, 31) the scene table."""
    o, d, zero = _rays(rays)
    if mode == "closest":
        return dense_closest(geom, o, d, zero, rays[7])
    if mode == "any":
        return dense_any(geom, o, d, zero + T_MIN_ANY, rays[7])
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    out = trace_interact_plain(table, (*rays[0:7], active), lite=mode == "lite")
    return out, _work(rays.shape[1] * geom.shape[0])


def woop_sweep_plain(woop, geom, table, rays, active, mode):
    """The plain version of the woop_sweep kernel: the dense sweep by the
    Woop test over `woop` (T, 12) rows, the winner's t, u, v re-derived by
    Möller–Trumbore from `geom`."""
    o, d, zero = _rays(rays)
    if mode == "any":
        return dense_any(woop, o, d, zero + T_MIN_ANY, rays[7], test=woop_rows_test)
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    t_max = rays[7] if mode == "closest" else torch.full_like(zero, T_MAX)
    hit, work = dense_closest(woop, o, d, zero, t_max, test=woop_rows_test)
    hit = _rederive(geom, o, d, hit)
    if mode == "closest":
        return hit, work
    t, prim, u, v = hit
    return interact_planes(table, (*rays[0:7], active), (t, u, v, prim.long()),
                           mode == "lite"), work


def aabb_sweep_plain(rows, geom, boxes, tile, rays, active, mode, woop=False):
    """The plain version of the aabb_sweep kernel (closest or any hit): the
    tiles of `tile` rows in scene order, each with its box of `boxes`
    (accel/woop.tile_boxes). A ray open at a tile (any hit: not yet
    occluded) makes a box test, the BVH walk's slab test capped by its best
    t (closest) or its t_max (any); the rays of a warp, 32 consecutive ones,
    sweep the tile when one of them hits its box, and skip it otherwise.
    rows: geometry rows, or with woop Woop rows (the winner then re-derived
    from `geom`)."""
    if mode not in ("closest", "any"):
        raise ValueError(f"the culled sweep runs closest or any hit, got {mode!r}")
    test = woop_rows_test if woop else mt_rows
    o, d, t_min = _rays(rays)
    closest = mode == "closest"
    if not closest:
        t_min = t_min + T_MIN_ANY
    n, dev = rays.shape[1], rays.device
    n_tris = rows.shape[0]
    inv = safe_inv(d)
    t_max = rays[7]
    best_t, bu, bv = t_max.clone(), torch.zeros_like(t_max), torch.zeros_like(t_max)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    box_tests = torch.zeros((), dtype=torch.int64, device=dev)
    pad = -n % WARP
    for ti in range(boxes.shape[0]):
        lo = ti * tile
        count = min(tile, n_tris - lo)
        open_ = ~occ
        box = boxes[ti][None, :].expand(n, 6)
        need = aabb_hit(o, inv, box, t_min, best_t if closest else t_max) & open_
        box_tests = box_tests + open_.sum()
        warp = torch.cat([need, need.new_zeros(pad)]).view(-1, WARP).any(dim=1)
        sweep = warp.repeat_interleave(WARP)[:n] & open_
        idx = torch.nonzero(sweep).squeeze(1)
        if idx.numel() == 0:
            continue
        sub = (tuple(x[idx] for x in o), tuple(x[idx] for x in d))
        if closest:
            (t, p, u, v), _w = dense_closest(rows[lo:lo + count], *sub, t_min[idx], best_t[idx],
                                             test=test)
            found = p >= 0
            best_t[idx] = t
            prim[idx] = torch.where(found, p + lo, prim[idx])
            bu[idx] = torch.where(found, u, bu[idx])
            bv[idx] = torch.where(found, v, bv[idx])
            tests = tests + idx.numel() * count
        else:
            hit, (t_work, _v) = dense_any(rows[lo:lo + count], *sub, t_min[idx], t_max[idx],
                                          test=test)
            occ[idx] = hit
            tests = tests + t_work.to(dev)
    work = _work(tests, box_tests)
    if not closest:
        return occ, work
    hit = (best_t, prim, bu, bv)
    return (_rederive(geom, o, d, hit) if woop else hit), work


def floor_probe_plain(a, b):
    """The floor probe's plain version: a + b."""
    return a + b


def leaf_accel(geom, leaf):
    """The BVH of `geom` with `leaf` slots a leaf, built as build_accel
    builds production's (accel/build.BVH_LEAF): the walks read each leaf's
    count from its reference."""
    return pack_bvh(geom, build_bvh_native(*_vertices(geom), leaf))


# ------------------------------------------------------------------ the rays


def _planes(o, d, n, dev, t_max=None):
    big = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    rays = torch.stack([*o, *d, big, big if t_max is None else t_max]).to(torch.float32)
    return rays.contiguous(), torch.ones((n,), dtype=torch.int32, device=dev)


def primary_rays(scene, res=(512, 512), seed=1, spp=16):
    """Coherent primaries: every pixel's first sample of the lcg sampler at
    `seed` through the scene's camera with the tent filter, the counterpart
    of start_sample_planes("lcg", ..., spp, ...) in
    tools/profile_sweep_variants.py:311 -> (rays (8, W*H), active)."""
    cfg = dataclasses.replace(scene._config(res, spp), sampler="lcg")
    tb = build_loop_tables(scene._data, scene.camera, cfg, seed)
    lanes = pixel_lanes(tb.res, tb.spp, scene.device)
    idx = torch.zeros((lanes.shape[1],), dtype=torch.int32, device=scene.device)
    (u0, u1), _smp = _sampler(tb, lanes, *_fresh_state(tb, lanes, idx)).next2_xy()
    o, d = camera_ray(tb.cam, lanes[0], lanes[1], u0, u1, tb.res, tb.use_tent)
    return _planes(o, d, lanes.shape[1], scene.device)


def bounce_rays(n, device, seed=7):
    """Incoherent bounce-like rays of tools/profile_sweep_variants.py:318-323:
    uniform directions from origins at radius 0.52 around the sphere's
    centre -> (rays (8, n), active)."""
    rs = np.random.RandomState(seed)
    dirs = rs.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    orig = rs.randn(n, 3).astype(np.float32)
    orig = 0.52 * orig / np.linalg.norm(orig, axis=1, keepdims=True)
    o = torch.as_tensor(orig.astype(np.float32), device=device).unbind(1)
    d = torch.as_tensor(dirs, device=device).unbind(1)
    return _planes(o, d, n, device)


def shadow_rays(geom, table, prim, seed=11):
    """Shadow rays of the primaries `prim` (rays, active): from each
    primary's closest hit (or 1 along a ray that misses) toward a uniform
    point of a uniformly chosen emissive triangle of `table`, t_max the
    distance to it -> (rays (8, n), active)."""
    rays, _act = prim
    n, dev = rays.shape[1], rays.device
    o, d, zero = _rays(rays)
    (t, p, _u, _v), _w = dense_closest(geom, o, d, zero, rays[7])
    t = torch.where(p >= 0, t, 1.0)
    org = tuple(o[k] + d[k] * t for k in range(3))
    lights = table[(table[:, 27:30] > 0).any(dim=1)]
    rs = np.random.RandomState(seed)
    pick = torch.as_tensor(rs.randint(0, lights.shape[0], n), device=dev)
    a, b = (torch.as_tensor(x.astype(np.float32), device=dev) for x in rs.rand(2, n))
    fold = a + b > 1.0
    a, b = torch.where(fold, 1.0 - a, a), torch.where(fold, 1.0 - b, b)
    row = lights[pick]
    target = tuple(row[:, k] + a * row[:, 3 + k] + b * row[:, 6 + k] for k in range(3))
    to = vsub(target, org)
    dist = torch.sqrt(to[0] * to[0] + to[1] * to[1] + to[2] * to[2])
    return _planes(org, vnormalize(to), n, dev, t_max=dist)
