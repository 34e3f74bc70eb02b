// The warp-cooperative replay of the path-loop gradient kernel, a design
// that studies/grad_split.py measures against the kernel's own (a finished
// sample replayed by its lane, path_loop_step.cuh replay_sample). Its
// builds include this file inside namespace zdr of path_loop_step.cuh,
// after replay_sample, and have run_lane call replay_warp on every step
// with every lane of the warp (see grad_split.py's "warp" edits). With
// STUDY_COUNT defined it also counts the replay's work into study_counts.

#ifdef STUDY_COUNT
// replay steps of a warp, rows, the steps' largest rows of a lane (the
// iterations of a replay by the finishing lanes), the steps' 32-row chunks
// (by the warp), then samples by their rows (0 .. 31, the last for 31 and
// more)
constexpr int kStudyCounts = 36;
__device__ unsigned long long study_counts[kStudyCounts];

// zero 1: clear the counters; 0: copy them to `host`. -> the CUDA error.
extern "C" int zdr_study_counts(unsigned long long* host, int zero) {
  if (zero) {
    unsigned long long z[kStudyCounts] = {};
    return (int)cudaMemcpyToSymbol(study_counts, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(host, study_counts, sizeof(study_counts));
}
#endif

// G' of row r of a sample whose last row is `last`: the radiance of rows
// last .. r + 1, summed from the last (G' is 0 at the last row), the order
// of replay_sample.
__device__ void suffix_radiance(const GradLane& gl, int col, long lane, int last, int r,
                                float& g0, float& g1, float& g2) {
  g0 = g1 = g2 = 0.0f;
  for (int j = last; j > r; --j) {
    long st;
    const float* row = tap_row(gl, col, lane, j, st);
    g0 = row[0] + g0;
    g1 = row[st] + g1;
    g2 = row[2 * st] + g2;
  }
}

// The ends of the samples of a warp, by the whole warp: every lane passes
// `last`, its finished sample's last row (-1: none this step), and the
// warp's rows, lane after lane, are dealt out 32 at a time, so the replay
// runs with all lanes busy instead of with only the finishing ones. Each
// row's G' is summed by its thread in replay_sample's order, so the taps
// are the same. Every lane of the warp must call it: the shuffles read
// all 32.
__device__ void replay_warp(const GradLane& gl, int last, int n_bins) {
  const unsigned full = 0xffffffffu;
  int lid = threadIdx.x & 31;
  int rows = last + 1;
  int incl = rows;
  for (int off = 1; off < 32; off <<= 1) {
    int v = __shfl_up_sync(full, incl, off);
    if (lid >= off) incl += v;
  }
  int total = __shfl_sync(full, incl, 31);
  if (total == 0) return;
  int excl = incl - rows;
#ifdef STUDY_COUNT
  int most = __reduce_max_sync(full, rows);
  if (lid == 0) {
    atomicAdd(study_counts, 1ull);
    atomicAdd(study_counts + 1, (unsigned long long)total);
    atomicAdd(study_counts + 2, (unsigned long long)most);
    atomicAdd(study_counts + 3, (unsigned long long)((total + 31) / 32));
  }
  if (rows > 0) atomicAdd(study_counts + 4 + (rows < 31 ? rows : 31), 1ull);
#endif
  __syncwarp();
  int col0 = gl.col - lid;
  long lane0 = gl.lane - lid;
  for (int base = 0; base < total; base += 32) {
    int p = base + lid;
    // the lane whose rows hold row p: the last with excl <= p
    int src = 0;
    for (int step = 16; step > 0; step >>= 1) {
      int e = __shfl_sync(full, excl, src + step);
      if (e <= p) src += step;
    }
    int first = __shfl_sync(full, excl, src);
    int src_last = __shfl_sync(full, last, src);
    if (p < total) {
      int r = src_last - (p - first);
      float g0, g1, g2;
      suffix_radiance(gl, col0 + src, lane0 + src, src_last, r, g0, g1, g2);
      long st;
      const float* row = tap_row(gl, col0 + src, lane0 + src, r, st);
      splat_row(gl.grad, n_bins, row, st, g0, g1, g2);
    }
  }
  __syncwarp();
}
