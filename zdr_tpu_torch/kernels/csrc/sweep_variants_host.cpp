// Host build of the sweep variants' per-ray code (sweep_variants.cuh) with
// g++: the rays in warps of 32, as the kernel's threads run them, so that a
// cull decided over a warp skips the same tiles. It runs the kernels' own code
// on the CPU, for tests without a card. Not used by the renderer.
//
// Build: g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
#include <vector>

#include "sweep_variants.cuh"

namespace {

template <bool kWoop, bool kAny>
void sweep_warps(int mode, int tile, bool cull, const float* rows, const float* geom,
                 const float* table, const float* boxes, int n_tris, const float* rays,
                 const int* active, float* f_out, int* i_out, unsigned long long* counts,
                 long n) {
  std::vector<zdr::SweepRay> s(zdr::kWarp);
  for (long w = 0; w < n; w += zdr::kWarp) {
    for (int l = 0; l < zdr::kWarp; ++l) s[l] = zdr::sweep_ray(rays, w + l, n, mode);
    for (int base = 0; base < n_tris; base += tile) {
      bool need = !cull;
      if (cull)
        for (int l = 0; l < zdr::kWarp; ++l)
          need = zdr::tile_need(s[l], boxes + 6 * (base / tile)) || need;
      if (!need) continue;
      int count = n_tris - base < tile ? n_tris - base : tile;
      for (int j = 0; j < count; ++j)
        for (int l = 0; l < zdr::kWarp; ++l)
          zdr::sweep_row<kWoop, kAny>(s[l], rows + (long)(base + j) * zdr::kGeomCols, base + j);
    }
    for (int l = 0; l < zdr::kWarp; ++l) {
      zdr::sweep_finish<kWoop>(s[l], mode, geom, table, rays, active, f_out, i_out, w + l, n);
      counts[0] += s[l].tests;
      counts[1] += s[l].box_tests;
    }
  }
}

}  // namespace

extern "C" {

// zdr_sweep_variant (sweep_variants.cu) without R and the stream: any grid
// point, the same outputs and counts.
int zdr_sweep_variant_host(int mode, int tile, int woop, int cull, const float* rows,
                           const float* geom, const float* table, const float* boxes,
                           int n_tris, const float* rays, const int* active, float* f_out,
                           int* i_out, unsigned long long* counts, int n) {
  if (mode < zdr::kModeClosest || mode > zdr::kModeLite || tile < 1) return 1;
  bool any = mode == zdr::kModeAny;
  auto run = woop ? (any ? &sweep_warps<true, true> : &sweep_warps<true, false>)
                  : (any ? &sweep_warps<false, true> : &sweep_warps<false, false>);
  run(mode, tile, cull != 0, rows, geom, table, boxes, n_tris, rays, active, f_out, i_out,
      counts, n);
  return 0;
}

}  // extern "C"
