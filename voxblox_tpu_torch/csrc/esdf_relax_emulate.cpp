// CPU emulation of the K1/K2 CUDA kernels, for the tests: compiles the
// device functions of esdf_relax.cu as plain C++ and runs `relax_block`
// for every active block with the CTA's threads executed one after the
// other, phase by phase (a phase ends where the kernel has a barrier).
// Built by the tests with
//   g++ -O1 -ffp-contract=off -shared -fPIC -o <lib> esdf_relax_emulate.cpp
// It checks the kernels' indexing, packing, recombination and schedule
// logic against the plain PyTorch version; what only the card can show
// (the build, the launch, shared-memory sizes, races) stays with the
// tests marked `cuda`.

#include <string.h>

#include <vector>

#include "esdf_relax.cu"

struct HostCta {
  Column cols[THREADS];
  template <class F>
  void each(F f) {
    for (int tid = 0; tid < THREADS; ++tid) f(tid, cols[tid]);
  }
  template <class F>
  bool each_any(F f) {
    bool any = false;
    for (int tid = 0; tid < THREADS; ++tid) any |= f(tid, cols[tid]);
    return any;
  }
  template <class F>
  void last(F f) {
    each(f);
  }
};

template <bool STRIDED>
static void run(const float* d, const uint8_t* obs, const uint8_t* upd,
                const uint8_t* cpos, const uint8_t* cneg,
                const uint8_t* active, float* out, int n, const Schedule& sch,
                float maxd, float min_diff) {
  std::vector<float2> side(P3), flip(P3);
  std::vector<float> own(ZC * THREADS);
  std::vector<uint32_t> codes(THREADS);
  const Shared sm = {side.data(), flip.data(), own.data(), codes.data()};
  HostCta cta;
  for (int b = 0; b < n; ++b) {
    const size_t base = (size_t)b * P3;
    if (!active[b]) {
      memcpy(out + base, d + base, P3 * sizeof(float));
      continue;
    }
    relax_block<STRIDED>(cta, sm, d + base, obs + base, upd + base,
                         STRIDED ? cpos + base : nullptr,
                         STRIDED ? cneg + base : nullptr, out + base, sch,
                         maxd, min_diff);
  }
}

// `strided` selects K2's code path (codes read, strides honoured), else
// K1's (sch->n sweeps with sch->step[0]).
extern "C" int esdf_relax_emulate(const float* d, const uint8_t* obs,
                                  const uint8_t* upd, const uint8_t* cpos,
                                  const uint8_t* cneg, const uint8_t* active,
                                  float* out, int n, const Schedule* sch,
                                  int strided, float maxd, float min_diff) {
  if (strided) {
    run<true>(d, obs, upd, cpos, cneg, active, out, n, *sch, maxd, min_diff);
  } else {
    run<false>(d, obs, upd, cpos, cneg, active, out, n, *sch, maxd, min_diff);
  }
  return 0;
}
