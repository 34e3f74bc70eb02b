// Ray-triangle intersection for one ray: the ordered BVH walk (closest and
// any hit), the dense sweep over a run of geometry rows, and the tracer
// that sends the megakernels' sweeps through the BVH.
//
// Replaces, by what they compute (a ray batch's closest hit t, u, v, prim or
// its occlusion against a triangle set), the big-mesh sweeps of the JAX
// package: zdr_tpu/integrators/pallas_stream.py::_stream_closest_kernel
// (:392) and ::_stream_any_kernel (:507), the HBM-streamed sweeps past 16384
// triangles, and the dense zdr_tpu/accel/pallas_trace.py::_closest_kernel
// (:35) and ::_any_kernel (:103). The TPU streamed triangle tiles through
// its matrix unit in a planned order; an H100 has no RT cores, so traversal
// is software either way, and a GPU thread walks a BVH. JAX's own walk
// (zdr_tpu/accel/trace.py::_bvh_stackless, :240) threads escape links to
// spare the TPU a per-lane stack, whose push and pop cost two serial row
// scatters a step there; it gives up near-child-first order, so a closest
// hit keeps testing subtrees behind the hit it ends with. A GPU thread has
// no such floor: this walk is JAX's ordered one (_bvh_loop, :143-237) over
// a layout made for it. What bounds it is the latency of its dependent
// loads, which L1 and L2 serve (the tree of 50,880 triangles is ~3 MB):
//   - a node holds both children's boxes and references (accel/bvh.py
//     to_child_nodes; Aila and Laine, HPG 2009): one visit is four 16-byte
//     loads and two slab tests, where a visit of the escape-link tree was
//     two link loads, then six box loads, then a decision;
//   - near child first, the far child pushed on a stack of kStackDepth
//     entries in local memory (through L1), internal nodes until a leaf
//     and then the leaf, so that a warp tests its leaves together;
//   - a leaf is (first row, count): no pads, and a row carries its global
//     id in float 9, so a triangle is three 16-byte loads.
// Each part was measured on an H100 (studies/walk_split.py; PERF.md):
// near-first order, the stack in local memory rather than shared memory
// (which takes L1 and resident blocks), the two loops and a leaf loop that
// is not unrolled pay; a skip on pop by an entry distance kept on the stack
// did not, and went. Leaves of up to
// 4 rows (accel/build.BVH_LEAF) beat or matched 2 and 8 in all four BVH
// kernels.
//
// The tie rule: among equal nearest t the smallest global triangle id wins,
// as the dense sweep's first-in-order does, and the box test admits a child
// whose near distance is <= the best t so far, widened by kSlabSlack so that
// it does not round out a hit on the box's face: the hit does not depend on
// the order of the visits, and the two routes give the same hit. JAX's walk
// breaks cross-leaf ties by visit order instead (trace.py:331-341), and its
// slab test has no slack.
//
// Every formula is the plain version's (zdr_tpu_torch/accel/trace.py) in its
// operand order, JAX's _safe_inv (1e-12) and _aabb_hit among them; build it
// as path_loop_step.cuh says (no FMA contraction, no fast math), and the
// kernel and the plain walk agree bit for bit, visits and tests too.
#pragma once

#include "path_loop_step.cuh"

namespace zdr {

// a triangle's geometry row: p0, e1, e2 in 12 floats (48 bytes, 16-byte
// aligned), a BVH's with the triangle's global id's bits in float
// kIdCol; the direct kernels' shared-memory rows and the BVH's leaf rows
constexpr int kGeomCols = 12;
constexpr int kIdCol = 9;
constexpr float kBig = 1e30f;  // _safe_inv's reciprocal of a tiny component
// the walk's stack: the deepest tree it takes, in internal nodes, JAX's
// MAX_STACK (accel/bvh.py MAX_DEPTH; to_child_nodes raises on a deeper
// tree); a walk touches only the entries below its depth
constexpr int kStackDepth = 64;
// a leaf child's reference: ~(first << kCountBits | count - 1)
// (accel/bvh.py COUNT_BITS)
constexpr int kCountBits = 4;

// The BVH in global memory (accel/bvh.py ChildNodes): n_nodes internal
// nodes of 16 floats, lo0 xyz hi0 xyz lo1 xyz hi1 xyz and the children's
// references' int bits (an internal child's row, or a leaf's
// ~(first << kCountBits | count - 1)); n_rows geometry rows in leaf order.
// A tree of one leaf has no internal node: the walk starts at that leaf.
struct Bvh {
  const float* nodes;
  const float* geom;
  int n_nodes;
  int n_rows;
};

// The 9 geometry floats of row `slot` of a (rows, kGeomCols) table -> the
// int bits of float kIdCol (a BVH row's global id), in the same three loads.
ZDR_HD int load_row(const float* geom, int slot, float* r) {
#ifdef __CUDA_ARCH__
  const float4* g = reinterpret_cast<const float4*>(geom + (long)slot * kGeomCols);
  float4 a = __ldg(g), b = __ldg(g + 1), c = __ldg(g + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x;
  return __float_as_int(c.y);
#else
  const float* row = geom + (long)slot * kGeomCols;
  memcpy(r, row, 9 * sizeof(float));
  int id;
  memcpy(&id, row + kIdCol, sizeof(int));
  return id;
#endif
}

// One internal node: both children's boxes and references.
struct Node {
  V3 lo0, hi0, lo1, hi1;
  int ref0, ref1;
};

ZDR_HD Node load_node(const Bvh& b, int node) {
  Node n;
#ifdef __CUDA_ARCH__
  const float4* p = reinterpret_cast<const float4*>(b.nodes) + 4L * node;
  float4 x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
  int4 w = __ldg(reinterpret_cast<const int4*>(p + 3));
  n.lo0 = v3(x.x, x.y, x.z);
  n.hi0 = v3(x.w, y.x, y.y);
  n.lo1 = v3(y.z, y.w, z.x);
  n.hi1 = v3(z.y, z.z, z.w);
  n.ref0 = w.x;
  n.ref1 = w.y;
#else
  const float* f = b.nodes + 16L * node;
  n.lo0 = v3(f[0], f[1], f[2]);
  n.hi0 = v3(f[3], f[4], f[5]);
  n.lo1 = v3(f[6], f[7], f[8]);
  n.hi1 = v3(f[9], f[10], f[11]);
  memcpy(&n.ref0, f + 12, sizeof(int));
  memcpy(&n.ref1, f + 13, sizeof(int));
#endif
  return n;
}

ZDR_HD float safe_inv(float x) {
  return fabsf(x) < 1e-12f ? (x >= 0.0f ? kBig : -kBig) : 1.0f / x;
}

// The slab test widens far and t_max by this factor (1 + 2^-20, 8 ulps):
// a hit on a box's face, such as a ray through a flat quad's corner, must
// not round out of it, or the walk would lose a hit that the dense sweep
// finds.
constexpr float kSlabSlack = 1.00000095367431640625f;

// The slab test of JAX's _aabb_hit, widened: near <= far', far' >= t_min,
// near <= t_max' (far' = far * kSlabSlack, t_max' = t_max * kSlabSlack);
// the ray's entry distance in `near`.
ZDR_HD bool slab(V3 o, V3 inv, V3 lo, V3 hi, float t_min, float t_max, float& near) {
  float x0 = (lo.x - o.x) * inv.x, x1 = (hi.x - o.x) * inv.x;
  float y0 = (lo.y - o.y) * inv.y, y1 = (hi.y - o.y) * inv.y;
  float z0 = (lo.z - o.z) * inv.z, z1 = (hi.z - o.z) * inv.z;
  near = jmax(jmax(jmin(x0, x1), jmin(y0, y1)), jmin(z0, z1));
  float far = jmin(jmin(jmax(x0, x1), jmax(y0, y1)), jmax(z0, z1)) * kSlabSlack;
  return near <= far && far >= t_min && near <= t_max * kSlabSlack;
}

// The ordered walk at t in (t_min, best_t), best_t coming in as t_max.
// Closest hit (kAny false): the nearest hit's global id (-1: none), with
// best_t, bu, bv of the hit. Any hit: 0 at the first hit, -1 for none.
// At an internal node both child boxes are tested, against the best t so
// far; the walk goes to the one hit, or to the nearer of two (the first on
// a tie) and pushes the other, or pops the stack; at a leaf its rows are
// tested in order, then the stack is popped. Two loops, internal nodes
// until a leaf and then the leaf ("while-while", Aila and Laine): a warp's
// lanes test their leaves together; a leaf's rows one at a time (unrolled,
// the loop spilled more at the kernels' 64 registers, and was slower). A
// popped entry is taken even when the best t has moved nearer than its box
// since it was pushed: an internal node's child boxes are then tested
// against the best t, a leaf's rows tested (skipping it on pop, by an entry
// distance kept on the stack, measured no faster: PERF.md).
template <bool kAny>
ZDR_HD int bvh_walk(const Bvh& b, V3 o, V3 d, float t_min, float& best_t, float& bu, float& bv,
                    TraceCount* c) {
  V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int prim = -1;
  if (b.n_rows == 0) return -1;
  int stack[kStackDepth];  // the far children still to visit
  int sp = 0;
  int ref = b.n_nodes ? 0 : ~(b.n_rows - 1);
  while (true) {
    while (ref >= 0) {
      if (c) c->visits += 1;
      Node nd = load_node(b, ref);
      float n0, n1;
      bool h0 = slab(o, inv, nd.lo0, nd.hi0, t_min, best_t, n0);
      bool h1 = slab(o, inv, nd.lo1, nd.hi1, t_min, best_t, n1);
      if (h0 && h1) {
        bool swap = n1 < n0;
        stack[sp++] = swap ? nd.ref0 : nd.ref1;
        ref = swap ? nd.ref1 : nd.ref0;
      } else if (h0 || h1) {
        ref = h0 ? nd.ref0 : nd.ref1;
      } else if (sp == 0) {
        return prim;
      } else {
        ref = stack[--sp];
      }
    }
    int e = ~ref;
    int first = e >> kCountBits, count = (e & ((1 << kCountBits) - 1)) + 1;
#pragma unroll 1
    for (int k = 0; k < count; ++k) {
      if (c) c->tests += 1;
      float r[9], t, u, v;
      int gid = load_row(b.geom, first + k, r);
      if (!mt_hit(r, o, d, t, u, v) || !(t > t_min)) continue;
      if (kAny) {
        if (t < best_t) return 0;
      } else if (t < best_t || (t == best_t && gid < prim)) {
        best_t = t;
        bu = u;
        bv = v;
        prim = gid;
      }
    }
    if (sp == 0) return prim;
    ref = stack[--sp];
  }
}

// Nearest hit at t in (t_min, best_t), best_t coming in as t_max -> the
// hit's global id (-1: none), with best_t, bu, bv of the hit.
ZDR_HD int bvh_closest(const Bvh& b, V3 o, V3 d, float t_min, float& best_t, float& bu,
                       float& bv, TraceCount* c) {
  return bvh_walk<false>(b, o, d, t_min, best_t, bu, bv, c);
}

// Any hit at t in (t_min, t_max); the walk stops at the first.
ZDR_HD bool bvh_any(const Bvh& b, V3 o, V3 d, float t_min, float t_max, TraceCount* c) {
  float bu = 0.0f, bv = 0.0f;
  return bvh_walk<true>(b, o, d, t_min, t_max, bu, bv, c) == 0;
}

// The dense sweep over `count` rows of kGeomCols floats whose first is the
// triangle `base`: nearest t in (t_min, best_t), the first of equal t.
ZDR_HD void dense_closest(const float* rows, int count, int base, V3 o, V3 d, float t_min,
                          float& best_t, float& bu, float& bv, int& prim) {
  for (int j = 0; j < count; ++j) {
    float t, u, v;
    if (mt_hit(rows + j * kGeomCols, o, d, t, u, v) && t > t_min && t < best_t) {
      best_t = t;
      bu = u;
      bv = v;
      prim = base + j;
    }
  }
}

// The dense any-hit sweep over `count` rows: -> the number of rows tested
// up to and including the first hit at t in (t_min, t_max), or -count.
ZDR_HD int dense_any(const float* rows, int count, V3 o, V3 d, float t_min, float t_max) {
  for (int j = 0; j < count; ++j) {
    float t, u, v;
    if (mt_hit(rows + j * kGeomCols, o, d, t, u, v) && t > t_min && t < t_max) return j + 1;
  }
  return -count;
}

// The megakernels' sweeps through the BVH (DenseSweep's interface): the
// shadow test at t in (1e-4, dist), the closest hit at t > 0; and for the
// direct kernels' emitter-first bounce lookup (direct_step.cuh bounce_emit)
// the bounce's any-hit from its offset origin, at t in (0, t_max).
struct BvhTrace {
  static constexpr bool kBvh = true;
  Bvh b;
  ZDR_HD bool any(const Tables&, const LoopParams&, V3 p, V3 wi, float dist,
                  TraceCount* c) const {
    return bvh_any(b, p, wi, 1e-4f, dist, c);
  }
  ZDR_HD bool bounce_any(const Tables&, const LoopParams&, V3 o, V3 d, float t_max,
                         TraceCount* c) const {
    return bvh_any(b, o, d, 0.0f, t_max, c);
  }
  ZDR_HD int closest(const Tables&, const LoopParams&, V3 o, V3 d, float& best_t, float& bu,
                     float& bv, TraceCount* c) const {
    return bvh_closest(b, o, d, 0.0f, best_t, bu, bv, c);
  }
};

// The BVH route keeps only the small tables in shared memory (or a host
// copy), where they fit: light, light-instance, point and camera rows, the
// floats of the packed tables after the (n_tris, 31) scene rows.
ZDR_HD int small_size(const LoopParams& q) { return tables_size(q) - q.n_tris * kSceneCols; }

// The tables over a copy of the small tables; the hit triangle's attributes
// from the full tables. No scene rows: the BVH's own rows are swept.
ZDR_HD Tables bvh_tables(const float* small, const float* tables, const float* bn,
                         const float* material, const LoopParams& q) {
  Tables t;
  t.scene = nullptr;
  t.attrs = tables;
  t.lights = small;
  t.linst = t.lights + q.n_light_tris * kLightCols;
  t.points = t.linst + q.n_mesh * 2;
  t.cam = t.points + q.n_point * 6;
  t.bn = bn;
  t.material = material;
  return t;
}

#ifdef __CUDACC__
// The small tables of a BVH kernel: copied into the block's shared memory
// when small_shared (they fit: kernels.small_tables_shared), else read from
// global memory where the packed tables hold them -> where they are.
__device__ inline const float* load_small(float* smem, const float* tables,
                                          const LoopParams& q, int small_shared) {
  const float* small = tables + (long)q.n_tris * kSceneCols;
  if (!small_shared) return small;
  for (int k = threadIdx.x; k < small_size(q); k += blockDim.x) smem[k] = small[k];
  __syncthreads();
  return smem;
}

// Sum each thread's count over its warp, one atomic a warp. Every thread of
// the block reaches it (no early return before).
__device__ inline void warp_add(unsigned long long* counter, unsigned long long local) {
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(counter, local);
}
#endif

}  // namespace zdr
