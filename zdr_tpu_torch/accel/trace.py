"""Batched ray-triangle intersection: the plain versions of the trace kernels.

Port of zdr_tpu/accel/trace.py's public API (`trace_closest`, `trace_any`,
:551-614) over the port's Accel:
  dense_closest / dense_any   every ray against every triangle, in chunks
                              of rays (the plain version of the dense mode
                              of kernels/csrc/accel.cu, B7/B8's counterpart);
  bvh_closest / bvh_any       the ordered walk of the child-box layout
                              (accel/bvh.to_child_nodes) for all rays at
                              once, each with a stack of its own, as JAX's
                              `_bvh_loop` (:143-237) keeps one a lane: one
                              node visit or one leaf per ray a step, a lane
                              idling once its walk is done (the plain
                              version of the walk in kernels/csrc/trace.cuh,
                              B5/B6's counterpart).
Both take and return tuples of (N,) tensors; t_min and t_max are (N,)
tensors. Each also returns its work: (ray-triangle tests, node visits), as
int64 tensors, counted as the kernels count them.

The tie rule: the closest hit is the nearest t in (t_min, t_max), and among
equal nearest t the smallest global triangle id, in both modes. The dense
sweep takes the first of equal t in global order, which is that id. The
BVH walk compares (t, id) pairs, so it finds the same triangle whatever the
order of its visits; JAX's walk breaks ties across leaves by visit order
instead (:331-341), which only a ray through a shared edge can tell apart.
The box test admits a child whose near distance is <= the best t so far,
with far and t_max widened by SLAB_SLACK: without the slack a hit on a
box's face
(a ray through a flat quad's corner, at 1 pixel of the protocol's 512x512
render) rounded out of the box, and the walk lost a hit that the dense
sweep finds. The two modes give the same hits.
"""

from __future__ import annotations

import torch

from ..vec import vcross, vdot, vsub
from .bvh import COUNT_BITS, MAX_DEPTH, leaf_ref
from .types import Hit

BIG = 1e30  # the t of a miss, and _safe_inv's reciprocal of a tiny component
# the slab test's widening of far and t_max: 1 + 2^-20, exact in float32
# (trace.cuh kSlabSlack)
SLAB_SLACK = 1.0 + 2.0**-20
# rays per chunk times triangles, so that a dense sweep's (N, T) planes stay
# small
_CHUNK_ELEMS = 1 << 22
# walk steps between checks that every lane is done (each check
# synchronises with the device)
_STEPS_PER_CHECK = 8


def chunks(n: int, n_tris: int):
    step = max(1, _CHUNK_ELEMS // max(n_tris, 1))
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def mt(p0, e1, e2, o, d):
    """Möller–Trumbore on broadcastable component tuples -> (ok without
    the t range, u, v, t), in the kernels' operand order (mt_hit)."""
    h = vcross(d, e2)
    a = vdot(e1, h)
    nz = torch.abs(a) > 1e-12
    f = torch.where(nz, 1.0 / torch.where(a == 0, 1.0, a), 0.0)
    sv = vsub(o, p0)
    u = f * vdot(sv, h)
    qv = vcross(sv, e1)
    v = f * vdot(d, qv)
    t = f * vdot(e2, qv)
    ok = nz & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return ok, u, v, t


def _row_cols(rows, idx=None):
    """p0, e1, e2 component tuples of geometry rows (all, or rows[idx])."""
    r = rows if idx is None else rows[idx]
    c = [r[..., k] for k in range(9)]
    return tuple(c[0:3]), tuple(c[3:6]), tuple(c[6:9])


def mt_rows(rows, o, d):
    """Möller–Trumbore of (N,) rays against every row of `rows` (T, >= 9)
    -> (N, T) planes (ok without the t range, u, v, t)."""
    p0, e1, e2 = (tuple(x[None, :] for x in c) for c in _row_cols(rows))
    return mt(p0, e1, e2, tuple(x[:, None] for x in o), tuple(x[:, None] for x in d))


# ------------------------------------------------------------------ dense


def dense_closest(rows, o, d, t_min, t_max, test=mt_rows):
    """Nearest hit of every ray over every row of `rows` (T, >= 9) by the
    ray-triangle `test` (mt_rows, or variants.woop_rows_test over Woop rows)
    -> (t, prim, u, v) (t_max, -1, 0, 0 on a miss) and the work."""
    n, n_tris = o[0].shape[0], rows.shape[0]
    parts = []
    for sl in chunks(n, n_tris):
        ok, u, v, t = test(rows, tuple(x[sl] for x in o), tuple(x[sl] for x in d))
        ok = ok & (t > t_min[sl, None]) & (t < t_max[sl, None])
        prim = torch.argmin(torch.where(ok, t, torch.inf), dim=1, keepdim=True)
        hit = torch.gather(ok, 1, prim)[:, 0]
        parts.append((
            torch.where(hit, torch.gather(t, 1, prim)[:, 0], t_max[sl]),
            torch.where(hit, prim[:, 0], -1).to(torch.int32),
            torch.where(hit, torch.gather(u, 1, prim)[:, 0], 0.0),
            torch.where(hit, torch.gather(v, 1, prim)[:, 0], 0.0),
        ))
    if not parts:
        z = t_max[:0]
        parts = [(z, z.to(torch.int32), z, z)]
    out = tuple(torch.cat(x) for x in zip(*parts))
    tests = torch.tensor(n * n_tris, dtype=torch.int64)
    return out, (tests, torch.zeros_like(tests))


def dense_any(rows, o, d, t_min, t_max, test=mt_rows):
    """Any hit at t in (t_min, t_max) per ray -> (occluded bool, the work:
    a ray's tests stop at its first hit, in global order)."""
    n, n_tris = o[0].shape[0], rows.shape[0]
    occ, tests = [], torch.zeros((), dtype=torch.int64, device=rows.device)
    for sl in chunks(n, n_tris):
        ok, _u, _v, t = test(rows, tuple(x[sl] for x in o), tuple(x[sl] for x in d))
        ok = ok & (t > t_min[sl, None]) & (t < t_max[sl, None])
        any_ = ok.any(dim=1)
        first = ok.to(torch.int8).argmax(dim=1) + 1
        tests = tests + torch.where(any_, first, n_tris).sum()
        occ.append(any_)
    occ = torch.cat(occ) if occ else torch.zeros((0,), dtype=torch.bool, device=rows.device)
    return occ, (tests.cpu(), torch.zeros((), dtype=torch.int64))


# -------------------------------------------------------------------- BVH


def safe_inv(d):
    """1 / d per component, +-1e30 where |d| < 1e-12 (JAX's _safe_inv)."""
    out = []
    for x in d:
        tiny = torch.abs(x) < 1e-12
        big = torch.where(x >= 0, BIG, -BIG).to(x.dtype)
        out.append(torch.where(tiny, big, 1.0 / torch.where(tiny, 1.0, x)))
    return tuple(out)


def slab(o, inv, lo, hi, t_min, t_max):
    """The slab test (JAX's _aabb_hit, widened by SLAB_SLACK) of each ray
    against its box, lo and hi (N, 3) -> (hit: near <= far', far' >= t_min,
    near <= t_max', with far' = far * SLAB_SLACK and t_max' likewise; the
    ray's entry distance near)."""
    near = far = None
    for k in range(3):
        t0 = (lo[:, k] - o[k]) * inv[k]
        t1 = (hi[:, k] - o[k]) * inv[k]
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = a if near is None else torch.maximum(near, a)
        far = b if far is None else torch.minimum(far, b)
    far = far * SLAB_SLACK
    return (near <= far) & (far >= t_min) & (near <= t_max * SLAB_SLACK), near


def aabb_hit(o, inv, box, t_min, t_max):
    """slab's hit against each ray's row of `box` (N, 6): lo xyz, hi xyz."""
    return slab(o, inv, box[:, 0:3], box[:, 3:6], t_min, t_max)[0]


def _walk(accel, o, d, t_min, t_max, closest: bool):
    """The ordered walk of every ray (trace.cuh bvh_walk): at an internal
    node, test both child boxes; go to the one hit, or to the nearer of two
    (the first on a tie) and push the other; at a leaf, test its rows; at a
    node with no child hit and after a leaf, pop the stack. The walk of a
    ray ends on an empty stack (or, for any-hit, at its first hit). A step
    pops the stack of a ray that left a node or a leaf the step before,
    then visits a node or tests a leaf."""
    n = o[0].shape[0]
    dev = o[0].device
    inv = safe_inv(d)
    best_t = t_max.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    n_rows = accel.geom.shape[0]
    m = accel.nodes.shape[0]
    # the root: row 0, or the one leaf of a tree without internal nodes
    root = 0 if m else int(leaf_ref(0, n_rows))
    ref = torch.full((n,), root, dtype=torch.int64, device=dev)
    live = torch.full((n,), n_rows > 0, dtype=torch.bool, device=dev)
    popping = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, MAX_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    nodes = accel.nodes if m else torch.zeros((1, accel.nodes.shape[1]), device=dev)
    refs = accel.node_refs.long() if m else torch.zeros((1, 2), dtype=torch.int64, device=dev)
    slots = torch.arange(max(accel.leaf_size, n_rows if not m else 1), device=dev)
    big_id = torch.iinfo(torch.int32).max
    while bool(live.any()):
        for _ in range(_STEPS_PER_CHECK):
            # the pops: a ray's walk ends on an empty stack
            live = live & ~(popping & (sp == 0))
            pop = live & popping
            top = torch.clamp(sp - 1, min=0)[:, None]
            ref = torch.where(pop, stack.gather(1, top)[:, 0], ref)
            sp = sp - pop.long()

            # an internal node: both child boxes
            inner = live & (ref >= 0)
            node = torch.where(inner, ref, 0)
            row = nodes[node]
            t_hi = best_t if closest else t_max
            h0, n0 = slab(o, inv, row[:, 0:3], row[:, 3:6], t_min, t_hi)
            h1, n1 = slab(o, inv, row[:, 6:9], row[:, 9:12], t_min, t_hi)
            h0, h1 = h0 & inner, h1 & inner
            visits = visits + inner.sum()
            r0, r1 = refs[node, 0], refs[node, 1]
            both = h0 & h1
            swap = n1 < n0
            # a push writes below MAX_DEPTH (to_child_nodes bounds the tree's
            # depth); the clamp keeps in range the column of a lane that does
            # not push, whose stack may be full
            col = torch.clamp(sp, max=MAX_DEPTH - 1)[:, None]
            stack.scatter_(1, col, torch.where(both, torch.where(swap, r0, r1),
                                               stack.gather(1, col)[:, 0])[:, None])
            sp = sp + both.long()
            nxt = torch.where(both, torch.where(swap, r1, r0), torch.where(h0, r0, r1))

            # a leaf: its rows [first, first + count)
            at_leaf = live & (ref < 0)
            e = torch.where(at_leaf, ~ref, 0)
            first, count = e >> COUNT_BITS, (e & ((1 << COUNT_BITS) - 1)) + 1
            real = at_leaf[:, None] & (slots[None, :] < count[:, None])
            slot = torch.clamp(first[:, None] + slots[None, :], max=max(n_rows - 1, 0))
            gid = accel.tri_perm[slot]
            p0, e1, e2 = _row_cols(accel.geom, slot)
            ok, u, v, t = mt(p0, e1, e2, tuple(x[:, None] for x in o),
                             tuple(x[:, None] for x in d))
            ok = ok & real & (t > t_min[:, None])
            if closest:
                tests = tests + real.sum()
                # the leaf's least (t, id), then against the best so far
                tl = torch.where(ok, t, torch.inf).amin(dim=1)
                cand = ok & (t == tl[:, None])
                gl = torch.where(cand, gid, big_id).amin(dim=1)
                pick = cand & (gid == gl[:, None])
                k = pick.to(torch.int8).argmax(dim=1, keepdim=True)
                better = pick.any(dim=1) & ((tl < best_t) | ((tl == best_t) & (gl < prim)))
                best_t = torch.where(better, tl, best_t)
                prim = torch.where(better, gl, prim)
                bu = torch.where(better, torch.gather(u, 1, k)[:, 0], bu)
                bv = torch.where(better, torch.gather(v, 1, k)[:, 0], bv)
            else:
                ok = ok & (t < t_max[:, None])
                found = ok.any(dim=1)
                # a walk stops at its first hit, in row order
                first_hit = ok.to(torch.int8).argmax(dim=1) + 1
                tests = tests + torch.where(found, first_hit, real.sum(dim=1)).sum()
                occ = occ | found
                live = live & ~found
            ref = torch.where(inner & (h0 | h1), nxt, ref)
            popping = (inner & ~(h0 | h1)) | at_leaf
    work = (tests.cpu(), visits.cpu())
    if closest:
        return (best_t, prim, bu, bv), work
    return occ, work


def bvh_closest(accel, o, d, t_min, t_max):
    """-> (t, prim, u, v) (t_max, -1, 0, 0 on a miss) and the work."""
    return _walk(accel, o, d, t_min, t_max, True)


def bvh_any(accel, o, d, t_min, t_max):
    """-> (occluded bool, the work)."""
    return _walk(accel, o, d, t_min, t_max, False)


# ------------------------------------------------------------ public API


def _per_ray(x, n, dev):
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=dev), (n,)).contiguous()


def trace_closest_plain(accel, o, d, t_min, t_max):
    """(N, 3) rays -> (t, prim, u, v) and the work, by the accel's mode."""
    n, dev = o.shape[0], o.device
    args = (tuple(o.unbind(1)), tuple(d.unbind(1)), _per_ray(t_min, n, dev),
            _per_ray(t_max, n, dev))
    if accel.is_bvh:
        return bvh_closest(accel, *args)
    return dense_closest(accel.geom, *args)


def trace_any_plain(accel, o, d, t_min, t_max):
    """(N, 3) rays -> occluded (N,) bool and the work, by the accel's mode."""
    n, dev = o.shape[0], o.device
    args = (tuple(o.unbind(1)), tuple(d.unbind(1)), _per_ray(t_min, n, dev),
            _per_ray(t_max, n, dev))
    if accel.is_bvh:
        return bvh_any(accel, *args)
    return dense_any(accel.geom, *args)


def trace_closest(accel, o: torch.Tensor, d: torch.Tensor, t_min=0.0, t_max=1e30) -> Hit:
    """Closest hit of (N, 3) rays at t in (t_min, t_max), scalars or (N,)
    (JAX trace.py:551). On a CUDA device the trace_closest kernel, on the
    CPU its plain version."""
    from .. import kernels

    t, prim, u, v = kernels.trace_closest(accel, o, d, t_min, t_max)
    miss = prim < 0
    inst = torch.where(miss, -1, accel.tri_inst[torch.clamp(prim, min=0).long()])
    return Hit(t=torch.where(miss, BIG, t), prim=prim, inst=inst.to(torch.int32),
               bary_u=u, bary_v=v)


def trace_any(accel, o: torch.Tensor, d: torch.Tensor, t_min=1e-4, t_max=1e30) -> torch.Tensor:
    """Any hit at t in (t_min, t_max) per ray (JAX trace.py:592) -> (N,)
    bool. On a CUDA device the trace_any kernel, on the CPU its plain
    version."""
    from .. import kernels

    return kernels.trace_any(accel, o, d, t_min, t_max)
