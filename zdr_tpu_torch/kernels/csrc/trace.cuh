// Ray-triangle intersection for one ray: the escape-link BVH walk (closest
// and any hit), the dense sweep over a run of geometry rows, and the tracer
// that sends the megakernels' sweeps through the BVH.
//
// Replaces, by what they compute (a ray batch's closest hit t, u, v, prim or
// its occlusion against a triangle set), the big-mesh sweeps of the JAX
// package: zdr_tpu/integrators/pallas_stream.py::_stream_closest_kernel
// (:392) and ::_stream_any_kernel (:507), the HBM-streamed sweeps past 16384
// triangles, and the dense zdr_tpu/accel/pallas_trace.py::_closest_kernel
// (:35) and ::_any_kernel (:103). The TPU streamed triangle tiles through
// its matrix unit in a planned order (row frusta, worklists, a packed key
// whose t lost its low 9 bits); an H100 has no RT cores, so traversal is
// software either way, and a GPU thread walks the escape-link BVH that the
// JAX package already builds (zdr_tpu/accel/bvh.py::to_stackless,
// accel/trace.py::_bvh_stackless): a node the ray's box test passes is left
// for id + 1, a leaf's slots (8) are tested, and a missed node or a finished
// leaf is left by its escape link. No stack: the walk fits a thread beside
// a megakernel's sample. It visits more nodes than an ordered walk with a
// short stack; ordering, wider nodes and ray sorting are later work.
//
// The tie rule: among equal nearest t the smallest global triangle id wins,
// as the dense sweep's first-in-order does, and the box test admits a node
// whose near distance is <= the best t so far, widened by kSlabSlack so that
// it does not round out a hit on the box's face: the two routes give the
// same hit. JAX's walk breaks cross-leaf ties by visit order instead
// (trace.py:331-341), and its slab test has no slack.
//
// Every formula is the plain version's (zdr_tpu_torch/accel/trace.py) in its
// operand order, JAX's _safe_inv (1e-12) and _aabb_hit among them; build it
// as path_loop_step.cuh says (no FMA contraction, no fast math), and the
// kernel and the plain walk agree bit for bit.
#pragma once

#include "path_loop_step.cuh"

namespace zdr {

constexpr int kLeafSize = 8;  // accel/bvh.py LEAF_SIZE: slots a leaf
// a triangle's geometry row: p0, e1, e2 in 12 floats (48 bytes, 16-byte
// aligned); the direct kernels' shared-memory rows and the BVH's leaf rows
constexpr int kGeomCols = 12;
constexpr float kBig = 1e30f;  // _safe_inv's reciprocal of a tiny component

// The BVH in global memory: node boxes (n_nodes, 6) lo xyz hi xyz; links
// (n_nodes, 2) escape and, for a leaf, its first slot + 1 (0 for an
// internal node); geometry rows (slots, kGeomCols) in leaf order; the
// global triangle id of each slot (-1 for a pad).
struct Bvh {
  const float* box;
  const int* link;
  const float* geom;
  const int* perm;
  int n_nodes;
};

// Reads through the read-only data path on the card.
ZDR_HD float ro_load(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

ZDR_HD int ro_load(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The 9 geometry floats of row `slot` of a (rows, kGeomCols) table.
ZDR_HD void load_row(const float* geom, int slot, float* r) {
#ifdef __CUDA_ARCH__
  const float4* g = reinterpret_cast<const float4*>(geom + (long)slot * kGeomCols);
  float4 a = __ldg(g), b = __ldg(g + 1), c = __ldg(g + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x;
#else
  memcpy(r, geom + (long)slot * kGeomCols, 9 * sizeof(float));
#endif
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
// near <= t_max' (far' = far * kSlabSlack, t_max' = t_max * kSlabSlack).
ZDR_HD bool aabb_hit(V3 o, V3 inv, const float* box, float t_min, float t_max) {
  float x0 = (ro_load(box + 0) - o.x) * inv.x, x1 = (ro_load(box + 3) - o.x) * inv.x;
  float y0 = (ro_load(box + 1) - o.y) * inv.y, y1 = (ro_load(box + 4) - o.y) * inv.y;
  float z0 = (ro_load(box + 2) - o.z) * inv.z, z1 = (ro_load(box + 5) - o.z) * inv.z;
  float near = jmax(jmax(jmin(x0, x1), jmin(y0, y1)), jmin(z0, z1));
  float far = jmin(jmin(jmax(x0, x1), jmax(y0, y1)), jmax(z0, z1)) * kSlabSlack;
  return near <= far && far >= t_min && near <= t_max * kSlabSlack;
}

// Nearest hit at t in (t_min, best_t), best_t coming in as t_max -> the
// hit's global id (-1: none), with best_t, bu, bv of the hit. leaf_slots:
// the tree's slots a leaf, kLeafSize but for the standalone trace kernels'
// leaf-width measurement (accel.cu), which pass it at run time.
ZDR_HD int bvh_closest(const Bvh& b, V3 o, V3 d, float t_min, float& best_t, float& bu,
                       float& bv, TraceCount* c, int leaf_slots = kLeafSize) {
  V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int prim = -1;
  int node = 0;
  while (node < b.n_nodes) {
    if (c) c->visits += 1;
    int esc = ro_load(b.link + 2 * node);
    int leaf = ro_load(b.link + 2 * node + 1);
    if (!aabb_hit(o, inv, b.box + 6 * node, t_min, best_t)) {
      node = esc;
    } else if (leaf == 0) {
      node += 1;
    } else {
      for (int k = 0; k < leaf_slots; ++k) {
        int slot = leaf - 1 + k;
        int gid = ro_load(b.perm + slot);
        if (gid < 0) continue;
        if (c) c->tests += 1;
        float r[9], t, u, v;
        load_row(b.geom, slot, r);
        if (mt_hit(r, o, d, t, u, v) && t > t_min &&
            (t < best_t || (t == best_t && gid < prim))) {
          best_t = t;
          bu = u;
          bv = v;
          prim = gid;
        }
      }
      node = esc;
    }
  }
  return prim;
}

// Any hit at t in (t_min, t_max); the walk stops at the first.
ZDR_HD bool bvh_any(const Bvh& b, V3 o, V3 d, float t_min, float t_max, TraceCount* c,
                    int leaf_slots = kLeafSize) {
  V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  int node = 0;
  while (node < b.n_nodes) {
    if (c) c->visits += 1;
    int esc = ro_load(b.link + 2 * node);
    int leaf = ro_load(b.link + 2 * node + 1);
    if (!aabb_hit(o, inv, b.box + 6 * node, t_min, t_max)) {
      node = esc;
    } else if (leaf == 0) {
      node += 1;
    } else {
      for (int k = 0; k < leaf_slots; ++k) {
        int slot = leaf - 1 + k;
        if (ro_load(b.perm + slot) < 0) continue;
        if (c) c->tests += 1;
        float r[9], t, u, v;
        load_row(b.geom, slot, r);
        if (mt_hit(r, o, d, t, u, v) && t > t_min && t < t_max) return true;
      }
      node = esc;
    }
  }
  return false;
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
// shadow test at t in (1e-4, dist), the closest hit at t > 0.
struct BvhTrace {
  static constexpr bool kBvh = true;
  Bvh b;
  ZDR_HD bool any(const Tables&, const LoopParams&, V3 p, V3 wi, float dist,
                  TraceCount* c) const {
    return bvh_any(b, p, wi, 1e-4f, dist, c);
  }
  ZDR_HD int closest(const Tables&, const LoopParams&, V3 o, V3 d, float& best_t, float& bu,
                     float& bv, TraceCount* c) const {
    return bvh_closest(b, o, d, 0.0f, best_t, bu, bv, c);
  }
};

// The BVH route keeps only the small tables in shared memory (or a host
// copy): light, light-instance, point and camera rows, the floats of the
// packed tables after the (n_tris, 31) scene rows.
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
// Sum each thread's count over its warp, one atomic a warp. Every thread of
// the block reaches it (no early return before).
__device__ inline void warp_add(unsigned long long* counter, unsigned long long local) {
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(counter, local);
}
#endif

}  // namespace zdr
