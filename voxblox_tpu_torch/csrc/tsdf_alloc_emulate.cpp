// CPU emulation of the block-walk-and-probe kernel, for the tests: compiles
// the device functions of tsdf_alloc.cu as plain C++ and runs the bodies of
// both launches one thread after the other. Built by the tests with
//   g++ -O1 -shared -fPIC -o <lib> tsdf_alloc_emulate.cpp
// The entry points have the CUDA library's names and signatures (the
// stream is ignored), so ops/tsdf_alloc.py's wrapper drives either. The
// atomicMax into the pending buffer becomes a plain max: the buffer holds
// the same largest lane id per cell in any order. What only the card can
// show (the build, the launch, the atomics, the warp reduction of the
// counters) stays with the tests marked `cuda`.

#include "tsdf_alloc.cu"

struct MaxSink {
  long long* win;
  void missing(long long lane, uint32_t cell) {
    if (lane > win[cell]) win[cell] = lane;
  }
};

extern "C" int tsdf_alloc_params_size(void) {
  return (int)sizeof(AllocParams);
}

extern "C" int tsdf_alloc_find(const AllocParams* p, void* /*stream*/) {
  MaxSink sink{p->win};
  for (int32_t r = 0; r < p->n_rays; ++r) {
    AllocCounts c = {0u, 0u, 0u, 0u};
    alloc_ray(*p, r, sink, c);
    if (c.missing) p->win[p->pending_size] = 1;
    if (p->counts != nullptr) {
      p->counts[0] += c.candidates;
      p->counts[1] += c.probed;
      p->counts[2] += c.missing;
      p->counts[3] += c.probes;
    }
  }
  return 0;
}

extern "C" int tsdf_alloc_keys(const AllocParams* p, void* /*stream*/) {
  for (int32_t i = 0; i < p->pending_size; ++i) pending_key(*p, i);
  return 0;
}
