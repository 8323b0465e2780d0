// CPU emulation of the walk-and-accumulate kernel, for the tests: compiles
// the device functions of tsdf_walk.cu as plain C++ and runs `walk_ray`
// for every lane, one after the other. Built by the tests with
//   g++ -O1 -ffp-contract=off -shared -fPIC -o <lib> tsdf_walk_emulate.cpp
// Each sample the kernel would add is written out as a record (lane, step,
// flat offset, pool row; w, w * sdf, cw, cw * rgb), and added into the
// accumulators of `p` in lane order, zero addends skipped as the kernel
// skips them. What only the card can show (the build, the launch, the
// atomics, the warp reduction of the counters) stays with the tests marked
// `cuda`.

#include "tsdf_walk.cu"

struct RecordSink {
  const WalkParams& p;
  int64_t* ints;  // [cap, 4]
  float* floats;  // [cap, 6]
  int64_t cap;
  int64_t n;
  void add(int32_t r, int32_t i, int64_t flat, int32_t row, float w,
           float wd, float cw, float wc0, float wc1, float wc2) {
    if (n < cap) {
      int64_t* a = ints + 4 * n;
      a[0] = r;
      a[1] = i;
      a[2] = flat;
      a[3] = row;
      float* f = floats + 6 * n;
      f[0] = w;
      f[1] = wd;
      f[2] = cw;
      f[3] = wc0;
      f[4] = wc1;
      f[5] = wc2;
    }
    ++n;
    if (w != 0.f) p.d_w[flat] += w;
    if (wd != 0.f) p.d_wd[flat] += wd;
    if (cw != 0.f) p.d_wcw[flat] += cw;
    if (wc0 != 0.f) p.d_wc[3 * flat] += wc0;
    if (wc1 != 0.f) p.d_wc[3 * flat + 1] += wc1;
    if (wc2 != 0.f) p.d_wc[3 * flat + 2] += wc2;
  }
  void mark(int32_t row) { p.dirty[row] = 1; }
};

extern "C" int tsdf_walk_params_size(void) { return (int)sizeof(WalkParams); }

// Runs every lane; returns the number of records (those past `cap` are
// counted, not written). counts[0..1]: probes and block lookups, as the
// kernel adds them into p->counts.
extern "C" int64_t tsdf_walk_emulate(const WalkParams* p, int64_t* ints,
                                     float* floats, int64_t cap,
                                     unsigned long long* counts) {
  RecordSink sink{*p, ints, floats, cap, 0};
  for (int32_t r = 0; r < p->n_rays; ++r) {
    WalkCounts c = {0u, 0u};
    walk_ray(*p, r, sink, c);
    counts[0] += c.probes;
    counts[1] += c.lookups;
  }
  return sink.n;
}

// The fused multiply-add the kernel computes (correctly rounded), for the
// tests to tell its results from ops/raycast.fma's double rounding.
extern "C" float tsdf_walk_fmaf(float a, float b, float c) {
  return fmaf(a, b, c);
}
