// The walk-and-accumulate kernel of the ray-casting TSDF integrators
// (`simple` and `merged`) for Hopper (sm_90a). Built by
// voxblox_tpu_torch/ops/tsdf_walk.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of the file).
//
// ---- What is computed ----------------------------------------------------
//
// It replaces no TPU kernel: the JAX package walks, weighs, looks up and
// scatters with XLA ops over [max_steps, rays] sample tensors, and the
// port's plain version (ops/tsdf.py: raycast.cast_rays ->
// _per_sample_contributions -> global_voxel_to_flat -> _accumulate_flat)
// does the same in PyTorch. On the card that chain stepped every lane in
// lockstep for max_steps steps, ~17 small launches a step, and pushed
// every (step, lane) sample through the later stages, masked or not.
//
// One thread per ray lane, for lanes that are valid:
//   walk    for i = 0 .. min(num_steps, max_steps - 1) the current voxel,
//           then the DDA step: the first minimum of t_next, x winning ties
//           over y and z, y over z (raycast.cast_rays; the start voxel,
//           step signs, t_next and t_step come from raycast.dda_start);
//   grazing (merged, enable_anti_grazing) skip a voxel that another
//           non-clearing bundle ends in, through the endpoint stamp table
//           (tsdf._anti_grazing_mask);
//   weigh   sdf and weight in the plain version's order: the two
//           multiply-adds that ops/raycast.fma emulates are fmaf, the
//           division IEEE, constants rounded to f32 as PyTorch rounds its
//           scalars; built with -fmad=false so nothing else contracts
//           (tsdf._per_sample_contributions);
//   lookup  the voxel's block in the hash table (core/hash.lookup: probes
//           0 .. *max_psl, stopping at the key or an empty cell; a slot at or
//           past max_blocks is missing), only when the walk enters another
//           block: the last block's pool row stays in registers;
//   scatter for a voxel in an allocated block, w, w * clamp(sdf), and with
//           colour cw and cw * rgb added into the pool-sized accumulators
//           (atomicAdd, result unused: a reduction), the block's dirty byte
//           set. A zero addend is skipped (exact: the sums start at +0).
// The sums' order is the atomics', as it was for index_add_ on the card.
// Per-ray set-up (segments, DDA start, |point - origin|) stays in PyTorch,
// computed as the plain version computes it, so the walk is the same.
//
// ---- What bounds it on this card, and what the design does ---------------
//
// The useful work is small: per sample inside a ray, a few tens of flops,
// two to five 4-byte atomic adds (w, w*sdf, cw, cw*rgb), and per block a
// walk enters one hash lookup (a few 12-byte probe reads). At the 5 cm
// cell's ~2.05 M useful samples and ~1 M block lookups a scan that is
// ~30-60 MB of traffic, ~10-20 us at 3.35 TB/s. The kernel is bound by
// latency: each step's lookup and atomics depend on the walk, and a warp
// runs as long as its longest ray (`integrate.walk_samples` counts the
// slots). The design keeps every intermediate in registers (nothing of a
// sample is written but its sums), looks up once per block entered, and
// launches once per scan instead of once per step and stage.
//
// The device functions compile as plain C++ too: the CPU tests build
// csrc/tsdf_walk_emulate.cpp, which runs `walk_ray` for every lane and
// holds each sample's record to the plain version bit for bit.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#else
#include <math.h>
#define DEV static inline
#endif

enum : int32_t {
  WALK_DROPOFF = 1,       // use_weight_dropoff
  WALK_SPARSITY = 2,      // use_sparsity_compensation_factor
  WALK_COLOR = 4,         // colour accumulators
  WALK_ANTI_GRAZING = 8,  // endpoint stamp table
};

constexpr int32_t EMPTY_W1 = -1;
constexpr uint32_t STAMP_MASK = (1u << 20) - 1;  // tsdf._anti_grazing_mask

// Everything one launch reads and writes (the ctypes structure
// tsdf_walk.WalkParams mirrors it field for field). Per-ray arrays are
// indexed by lane, [R] or [R, 3] row-major.
struct WalkParams {
  const int32_t* start;      // [R,3] start voxel
  const int32_t* step;       // [R,3] step signs
  const float* t_next;       // [R,3]
  const float* t_step;       // [R,3]
  const int32_t* num_steps;  // [R]
  const uint8_t* valid;      // [R]
  const float* origin;       // [3]
  const float* v_po;         // [R,3] point - origin
  const float* dist;         // [R] |point - origin|
  const float* weight;       // [R]
  const float* color;        // [R,3], read with WALK_COLOR
  const uint8_t* stamp;      // [2^20], read with WALK_ANTI_GRAZING
  const int32_t* endpoint;   // [R,3] the lane's endpoint voxel, likewise
  const uint8_t* clearing;   // [R], likewise
  const int32_t* keys_w0;    // [capacity]
  const int32_t* keys_w1;    // [capacity]
  const int32_t* slot;       // [capacity]
  const int32_t* max_psl;    // [] the table's probe bound
  float* d_w;                // [max_blocks * vps^3]
  float* d_wd;               // likewise
  float* d_wcw;              // likewise
  float* d_wc;               // [max_blocks * vps^3, 3]
  uint8_t* dirty;            // [max_blocks]
  unsigned long long* counts;  // [2] probes, block lookups; or null
  int32_t n_rays;
  int32_t max_steps;
  int32_t cap_mask;    // table capacity - 1
  int32_t max_blocks;
  int32_t vps_log2;
  int32_t flags;       // WALK_*
  float voxel_size;    // f32(voxel_size)
  float trunc;         // f32(truncation distance)
  float neg_dropoff;   // f32(-voxel_size)
  float dropoff_den;   // f32(truncation - voxel_size), taken in double
  float sparsity;      // f32(sparsity_compensation_factor)
  float eps;           // f32(grid.FLOAT_EPS)
};

struct WalkCounts {
  uint32_t probes;   // hash cells read
  uint32_t lookups;  // block lookups
};

DEV uint32_t hash_words(uint32_t w0, uint32_t w1) {  // core/hash.hash_words
  uint32_t h = w0 * 0x9E3779B1u;
  h ^= w1 * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

DEV uint32_t hash_gvi(int32_t x, int32_t y, int32_t z) {  // tsdf._hash_gvi
  uint32_t h = ((uint32_t)x * 0x9E3779B1u) ^ ((uint32_t)y * 0x85EBCA6Bu) ^
               ((uint32_t)z * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

// Pool row of block (bx, by, bz), or -1: core/layer.lookup_blocks.
DEV int32_t lookup_row(const WalkParams& p, int32_t bx, int32_t by,
                       int32_t bz, int32_t max_psl, WalkCounts& c) {
  // grid.pack_block_index
  const uint32_t w0 =
      ((uint32_t)bx & 0xFFFFu) | ((((uint32_t)by + 32768u) & 0xFFFFu) << 16);
  const int32_t w1 = bz + 32768;
  const uint32_t h = hash_words(w0, (uint32_t)w1);
  ++c.lookups;
  for (int32_t q = 0; q <= max_psl; ++q) {
    const uint32_t idx = (h + (uint32_t)q) & (uint32_t)p.cap_mask;
    ++c.probes;
    const int32_t k1 = p.keys_w1[idx];
    if (k1 == w1 && p.keys_w0[idx] == (int32_t)w0) {
      const int32_t s = p.slot[idx];
      return s < p.max_blocks ? s : -1;
    }
    if (k1 == EMPTY_W1) return -1;
  }
  return -1;
}

// One lane's walk. `sink.add` takes every sample that is in its mask and
// in an allocated block; `sink.mark` the row of each block entered that
// takes one.
template <class Sink>
DEV void walk_ray(const WalkParams& p, int32_t r, Sink& sink,
                  WalkCounts& c) {
  if (!p.valid[r]) return;
  int32_t cx = p.start[3 * r], cy = p.start[3 * r + 1],
          cz = p.start[3 * r + 2];
  const int32_t sx = p.step[3 * r], sy = p.step[3 * r + 1],
                sz = p.step[3 * r + 2];
  float tx = p.t_next[3 * r], ty = p.t_next[3 * r + 1],
        tz = p.t_next[3 * r + 2];
  const float dtx = p.t_step[3 * r], dty = p.t_step[3 * r + 1],
              dtz = p.t_step[3 * r + 2];
  const int32_t n = p.num_steps[r];
  const int32_t last = n < p.max_steps - 1 ? n : p.max_steps - 1;
  const float nox = -p.origin[0], noy = -p.origin[1], noz = -p.origin[2];
  const float bx = p.v_po[3 * r], by = p.v_po[3 * r + 1],
              bz = p.v_po[3 * r + 2];
  const float dist = p.dist[r];
  const float dist_c = dist < p.eps ? p.eps : dist;  // clamp(min=eps)
  const float w_ray = p.weight[r];
  const bool color = (p.flags & WALK_COLOR) != 0;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (color) {
    c0 = p.color[3 * r];
    c1 = p.color[3 * r + 1];
    c2 = p.color[3 * r + 2];
  }
  const bool grazing = (p.flags & WALK_ANTI_GRAZING) != 0;
  int32_t ex = 0, ey = 0, ez = 0;
  bool own_end = false;
  if (grazing) {
    ex = p.endpoint[3 * r];
    ey = p.endpoint[3 * r + 1];
    ez = p.endpoint[3 * r + 2];
    own_end = !p.clearing[r];
  }
  const int32_t max_psl = *p.max_psl;
  const int32_t lg = p.vps_log2;
  const int32_t lmask = (1 << lg) - 1;
  const int64_t vpb = (int64_t)1 << (3 * lg);
  int32_t kbx = 0, kby = 0, kbz = 0, row = -1;
  bool have = false, marked = false;
  for (int32_t i = 0; i <= last; ++i) {
    if (i > 0) {  // the DDA step from voxel i - 1
      const bool ax_x = (tx <= ty) && (tx <= tz);
      const bool ax_y = !ax_x && (ty <= tz);
      if (ax_x) {
        cx += sx;
        tx += dtx;
      } else if (ax_y) {
        cy += sy;
        ty += dty;
      } else {
        cz += sz;
        tz += dtz;
      }
    }
    if (grazing && p.stamp[hash_gvi(cx, cy, cz) & STAMP_MASK] &&
        !(own_end && cx == ex && cy == ey && cz == ez)) {
      continue;
    }
    const int32_t qx = cx >> lg, qy = cy >> lg, qz = cz >> lg;
    if (!have || qx != kbx || qy != kby || qz != kbz) {
      row = lookup_row(p, qx, qy, qz, max_psl, c);
      kbx = qx;
      kby = qy;
      kbz = qz;
      have = true;
      marked = false;
    }
    if (row < 0) continue;
    // Weigh (tsdf._per_sample_contributions).
    const float ax = fmaf((float)cx + 0.5f, p.voxel_size, nox);
    const float ay = fmaf((float)cy + 0.5f, p.voxel_size, noy);
    const float az = fmaf((float)cz + 0.5f, p.voxel_size, noz);
    const float dot = fmaf(az, bz, fmaf(ay, by, ax * bx));
    const float sdf = dist - dot / dist_c;
    float w = w_ray;
    if ((p.flags & WALK_DROPOFF) && sdf < p.neg_dropoff) {
      const float v = w * ((p.trunc + sdf) / p.dropoff_den);
      w = v < 0.f ? 0.f : v;
    }
    const float asdf = fabsf(sdf);
    if ((p.flags & WALK_SPARSITY) && asdf < p.trunc) w = w * p.sparsity;
    // Scatter (tsdf._accumulate_flat).
    const float sdf_c = sdf < -p.trunc ? -p.trunc
                        : sdf > p.trunc ? p.trunc
                                        : sdf;
    const float cw = color && asdf < p.trunc ? w : 0.f;
    const int64_t lin = (int64_t)(cx & lmask) + ((int64_t)(cy & lmask) << lg) +
                        ((int64_t)(cz & lmask) << (2 * lg));
    sink.add(r, i, (int64_t)row * vpb + lin, row, w, w * sdf_c, cw, cw * c0,
             cw * c1, cw * c2);
    if (!marked) {
      sink.mark(row);
      marked = true;
    }
  }
}

#ifdef __CUDACC__

struct AtomicSink {
  const WalkParams& p;
  DEV void add(int32_t, int32_t, int64_t flat, int32_t, float w, float wd,
               float cw, float wc0, float wc1, float wc2) {
    if (w != 0.f) atomicAdd(p.d_w + flat, w);
    if (wd != 0.f) atomicAdd(p.d_wd + flat, wd);
    if (cw != 0.f) atomicAdd(p.d_wcw + flat, cw);
    if (wc0 != 0.f) atomicAdd(p.d_wc + 3 * flat, wc0);
    if (wc1 != 0.f) atomicAdd(p.d_wc + 3 * flat + 1, wc1);
    if (wc2 != 0.f) atomicAdd(p.d_wc + 3 * flat + 2, wc2);
  }
  DEV void mark(int32_t row) { p.dirty[row] = 1; }
};

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
tsdf_walk_kernel(const __grid_constant__ WalkParams p) {
  const int32_t r = (int32_t)(blockIdx.x * THREADS + threadIdx.x);
  WalkCounts c = {0u, 0u};
  if (r < p.n_rays) {
    AtomicSink sink{p};
    walk_ray(p, r, sink, c);
  }
  if (p.counts != nullptr) {  // every thread of the warp gets here
    const uint32_t probes = __reduce_add_sync(0xFFFFFFFFu, c.probes);
    const uint32_t lookups = __reduce_add_sync(0xFFFFFFFFu, c.lookups);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(p.counts, (unsigned long long)probes);
      atomicAdd(p.counts + 1, (unsigned long long)lookups);
    }
  }
}

extern "C" int tsdf_walk_params_size(void) { return (int)sizeof(WalkParams); }

extern "C" int tsdf_walk(const WalkParams* p, void* stream) {
  if (p->n_rays <= 0) return 0;
  const int blocks = (p->n_rays + THREADS - 1) / THREADS;
  tsdf_walk_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
