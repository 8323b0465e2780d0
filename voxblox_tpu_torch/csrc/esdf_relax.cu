// K1 and K2: ESDF 26-neighbour relaxation for Hopper (sm_90a): K1 the
// unit-stride schedule, K2 (second half of this file) a schedule with
// strides > 1. Built by voxblox_tpu_torch/ops/esdf_relax.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).
//
// ---- K1 -----------------------------------------------------------------
//
// Replaces the TPU kernel voxblox_tpu/ops/pallas/esdf_relax.py
// `_relax_kernel` (launched by `relax_2d`, pallas_call at :395), unit
// strides only. Same arithmetic, voxel for voxel: `inner_sweeps` Jacobi
// sweeps of the quasi-Euclidean chamfer (steps 1, sqrt2, sqrt3 voxels).
// Per sweep, a neighbour is a source when observed and |d| < max_distance
// (recomputed every sweep); invalid sources are packed to +-BIG by sign;
// per step group the positive side takes the min and the negative side the
// max; the sign-flip cap (a positive centre with a valid negative
// neighbour below d - 2*step, mirrored for negative centres) caps |d| at
// the step, smallest tripped step winning; a voxel is written where `upd`
// holds and |cand - d| > min_diff. The step constants arrive from the host,
// computed exactly as the plain version computes them.
//
// Layout: d f32[N,18,18,18] padded blocks ([z,y,x], the 1-voxel ring holds
// the neighbours' halo and is only read), obs/upd u8 0/1 of the same shape
// (upd is 0 on the ring), active u8[N]. Updated in place: each block's ring
// is its own copy of the halo, so blocks never read each other and there
// is no race between CTAs.
//
// Activity gate, per block: a block with active == 0 returns at once. The
// caller sets a block active when it or a 1-ring neighbour changed by more
// than min_diff in the previous outer iteration. Otherwise the block's
// padded state (interior and ring) is exactly what its previous launch
// left, and that launch wrote none of its voxels: every write needs
// |cand - d| > min_diff, which would have flagged the block as changed.
// The sweep is a deterministic function of the padded state, so a state
// on which a whole launch wrote nothing is a fixpoint, and skipping the
// block gives the values running it would. The TPU kernel gates per tile
// of 8 blocks; gating per block gives the same values.
//
// What bounds it. The operations the function needs per block and sweep
// (chip_smoke.py OPS_PER_BLOCK_SWEEP = 18^3 * 10 + 16^3 * (26 * 4 +
// 49) = 685,008, ~167 per interior voxel):
//   packing, once per padded voxel (each is a source for its neighbours):
//     |d|, < max_distance, & obs, > 0, two ands and two selects for the
//     +-BIG packed pair, two selects for the trip-test values       10
//   per interior voxel and neighbour: min, max of the packed pair and
//     min, max of the trip-test values                        26 x  4
//   group finish, per interior voxel: 3 step adds + 2 mins, 3 step
//     subs + 2 maxes, centre sign + min + max + select (4), per group
//     threshold c-2s, c+2s, two compares, side select (3 x 5), per group
//     cap |cand|, compare, and, +-step select, select (3 x 5), write
//     test sub, |.|, compare, & upd, select (5)                     49
// Bytes: the output is a new tensor (the sweep compares it with its
// input), so d is read and the output written for all N blocks (4 + 4
// bytes per padded voxel); obs and upd are read only for active blocks
// (1 + 1 byte). At N = 512 with 251 active and 4 sweeps: 0.69 G operations
// (~10.3 us at 67 TFLOP/s) against 26.8 MB (~8.0 us at 3.35 TB/s):
// operation-bound, narrowly. This kernel runs more than that count: each
// thread re-packs every neighbour (about 15 operations per neighbour,
// ~435 per voxel, 2.6x the count above). The design keeps all of a block's
// sweeps in shared memory (one global read and one write per launch) and
// spends operations only on active blocks. Packing once per sweep into
// shared memory and register tiling along x are later work.
//
// One CTA of 256 threads per padded block. Shared memory: the 18^3 f32
// distances (23,328 B) plus the 18^3 obs bytes (5,832 B), under the 48 KB
// static limit. Each thread owns 16 interior voxels (x fastest across
// threads); a sweep computes their candidates from shared memory into
// registers, waits at a barrier, writes them, and waits again: exact
// Jacobi, like the TPU kernel's whole-tile update.

#include <cuda_runtime.h>
#include <stdint.h>

#define P 18
#define P2 (P * P)
#define P3 (P * P * P)
#define NT 256
#define PER_THREAD 16  // 4096 interior voxels / 256 threads

__device__ __forceinline__ void src_pair(const float* sd, const uint8_t* so,
                                         int n, float maxd, float big,
                                         float& dp, float& dn) {
  float v = sd[n];
  bool ok = so[n] != 0 && fabsf(v) < maxd;
  bool pos = v > 0.0f;
  dp = (ok && pos) ? v : big;
  dn = (ok && !pos) ? v : -big;
}

__device__ __forceinline__ void fold(float dp, float dn, float big,
                                     float& gp, float& gn, float& tvn,
                                     float& tvp) {
  gp = fminf(gp, dp);
  gn = fmaxf(gn, dn);
  tvn = fminf(tvn, dn > -big * 0.5f ? dn : big);
  tvp = fmaxf(tvp, dp < big * 0.5f ? dp : -big);
}

// One voxel of a unit-stride sweep: its new value from the block's current
// values in shared memory (K1's whole arithmetic; K2 runs it for the
// stride-1 entries of its schedule).
__device__ __forceinline__ float unit_candidate(
    const float* sd, const uint8_t* so, int c0, bool upd, float s1, float s2,
    float s3, float maxd, float min_diff, float big) {
  const float c = sd[c0];
  float g1p = big, g1n = -big, t1n = big, t1p = -big;
  float g2p = big, g2n = -big, t2n = big, t2p = -big;
  float g3p = big, g3n = -big, t3n = big, t3p = -big;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int nz = (dx != 0) + (dy != 0) + (dz != 0);
        if (nz == 0) continue;
        float dp, dn;
        src_pair(sd, so, c0 + dz * P2 + dy * P + dx, maxd, big, dp, dn);
        if (nz == 1) fold(dp, dn, big, g1p, g1n, t1n, t1p);
        else if (nz == 2) fold(dp, dn, big, g2p, g2n, t2n, t2p);
        else fold(dp, dn, big, g3p, g3n, t3n, t3p);
      }
    }
  }
  const bool pos = c > 0.0f;
  float bp = fminf(fminf(fminf(big, g1p + s1), g2p + s2), g3p + s3);
  float bn = fmaxf(fmaxf(fmaxf(-big, g1n - s1), g2n - s2), g3n - s3);
  float cand = pos ? fminf(c, bp) : fmaxf(c, bn);
  const float sg = pos ? 1.0f : -1.0f;
  // Flip caps, largest step first so the smallest tripped step wins.
  const bool tr3 = pos ? (t3n < c - 2.0f * s3) : (t3p > c + 2.0f * s3);
  const bool tr2 = pos ? (t2n < c - 2.0f * s2) : (t2p > c + 2.0f * s2);
  const bool tr1 = pos ? (t1n < c - 2.0f * s1) : (t1p > c + 2.0f * s1);
  if (tr3 && fabsf(cand) > s3) cand = sg * s3;
  if (tr2 && fabsf(cand) > s2) cand = sg * s2;
  if (tr1 && fabsf(cand) > s1) cand = sg * s1;
  const bool take = upd && fabsf(cand - c) > min_diff;
  return take ? cand : c;
}

__global__ void __launch_bounds__(NT)
esdf_relax_k1_kernel(float* __restrict__ d, const uint8_t* __restrict__ obs,
                     const uint8_t* __restrict__ upd,
                     const uint8_t* __restrict__ active, int inner_sweeps,
                     float s1, float s2, float s3, float maxd,
                     float min_diff) {
  const int b = blockIdx.x;
  if (!active[b]) return;
  const float big = 1e9f;
  __shared__ float sd[P3];
  __shared__ uint8_t so[P3];
  float* gd = d + (size_t)b * P3;
  const uint8_t* go = obs + (size_t)b * P3;
  const uint8_t* gu = upd + (size_t)b * P3;
  for (int i = threadIdx.x; i < P3; i += NT) {
    sd[i] = gd[i];
    so[i] = go[i];
  }
  int cell[PER_THREAD];
  uint32_t umask = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    int j = threadIdx.x + k * NT;
    int z = j >> 8, y = (j >> 4) & 15, x = j & 15;
    cell[k] = (z + 1) * P2 + (y + 1) * P + (x + 1);
    if (gu[cell[k]]) umask |= 1u << k;
  }
  __syncthreads();

  float nv[PER_THREAD];
  for (int s = 0; s < inner_sweeps; ++s) {
#pragma unroll 2
    for (int k = 0; k < PER_THREAD; ++k) {
      nv[k] = unit_candidate(sd, so, cell[k], (umask >> k) & 1u, s1, s2, s3,
                             maxd, min_diff, big);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) sd[cell[k]] = nv[k];
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) gd[cell[k]] = sd[cell[k]];
}

extern "C" int esdf_relax_k1(void* d, const void* obs, const void* upd,
                             const void* active, int n, int inner_sweeps,
                             float s1, float s2, float s3, float maxd,
                             float min_diff, void* stream) {
  if (n <= 0) return 0;
  esdf_relax_k1_kernel<<<n, NT, 0, (cudaStream_t)stream>>>(
      (float*)d, (const uint8_t*)obs, (const uint8_t*)upd,
      (const uint8_t*)active, inner_sweeps, s1, s2, s3, maxd, min_diff);
  return (int)cudaGetLastError();
}

// ---- K2 -----------------------------------------------------------------
//
// Replaces the same TPU kernel, `_relax_kernel`, run with a schedule that
// has a stride k > 1 (`strides` and `stride_codes`, esdf_relax.py :94-99,
// :123-142, :151-161, :208-230; launched by `relax_2d`, pallas_call :395).
// One relaxation per schedule entry, in order. A stride-1 entry is K1's
// sweep (unit_candidate above). A stride-k entry, k > 1:
//   - a voxel's source for offset (dx,dy,dz) is the voxel k*(dx,dy,dz)
//     away in the same padded 18^3 cube; a source coordinate outside
//     [0,17] is rejected (the TPU kernel rolls lanes and masks the same
//     coordinates); there is no read across blocks inside a launch;
//   - source validity is recomputed from the current values every sweep
//     (observed and |d| < max_distance), packed by sign as in K1;
//   - a positive source counts only where the centre's code_pos reaches
//     the stride's level and value + step < max_distance; a negative one
//     only where code_neg reaches it and value - step > -max_distance;
//     step = k * unit step, built on the host exactly as the plain
//     version builds it;
//   - no sign-flip rule; the write test (upd and |cand - d| > min_diff)
//     is K1's.
// Only the centre's own sign decides which side its candidate takes
// (min with the positive side for d > 0, max with the negative side
// otherwise), so the kernel evaluates that side alone; the other side's
// extrema never reach the result.
//
// Layout: as K1, plus code_pos/code_neg u8[N,18,18,18] holding levels
// 0..3 (level i+1 = the i-th distinct stride > 1, ascending; built by
// ops/esdf.stride_codes by eroding the traversable mask). A thread keeps
// its 16 cells' codes in two 32-bit registers, 2 bits a cell.
//
// Activity gate, per block, as K1, and the argument holds for a strided
// schedule: codes, obs and upd are static across the outer iterations of
// one update, every write of every sweep moves a value toward zero by
// more than min_diff (candidates are minima on the positive side, maxima
// on the negative side, and flip caps only shrink |d|), so a launch that
// left a block unchanged wrote none of its voxels in any of its sweeps,
// and the same schedule on the same padded state writes none again.
//
// What bounds it (chip_smoke.py relax_ops_needed): per active block and
// strided sweep the packing of K1 (18^3 * 10) and one gate test per
// interior voxel (own-sign code, compare with the level, and upd: 3);
// per voxel whose gate is open, for each neighbour inside the cube the
// window test and the running extremum (add step, compare, select,
// min/max: 4), and the finish (3 step adds, 3 min/max, min/max with the
// centre, subtract, |.|, compare, select: 11). Bytes: d read and the
// output written for all N blocks, obs, upd and both code cubes read for
// active blocks. With few gates open the bytes bound it; a unit entry of
// the schedule adds K1's count.
//
// One CTA of 256 threads per block, the same shared-memory tile and
// two-barrier Jacobi step as K1.

#define MAX_SCHEDULE 16

struct Schedule {
  int n;
  int stride[MAX_SCHEDULE];
  int level[MAX_SCHEDULE];  // 0 at stride 1
  float step[MAX_SCHEDULE][3];
};

// One voxel of a stride-k sweep (k > 1) whose gate is open; (x,y,z) are
// its padded coordinates.
__device__ __forceinline__ float strided_candidate(
    const float* sd, const uint8_t* so, int c0, int x, int y, int z, int k,
    float s1, float s2, float s3, float maxd, float min_diff, float big) {
  const float c = sd[c0];
  const bool pos = c > 0.0f;
  const float lose = pos ? big : -big;
  float g1 = lose, g2 = lose, g3 = lose;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int nz = (dx != 0) + (dy != 0) + (dz != 0);
        if (nz == 0) continue;
        const int sx = x + k * dx, sy = y + k * dy, sz = z + k * dz;
        if ((unsigned)sx >= P || (unsigned)sy >= P || (unsigned)sz >= P)
          continue;
        const int n = sz * P2 + sy * P + sx;
        const float v = sd[n];
        const bool ok = so[n] != 0 && fabsf(v) < maxd;
        const float s = nz == 1 ? s1 : (nz == 2 ? s2 : s3);
        float nd;
        if (pos) {
          nd = (ok && v > 0.0f) ? v : big;
          nd = (nd + s < maxd) ? nd : big;
        } else {
          nd = (ok && !(v > 0.0f)) ? v : -big;
          nd = (nd - s > -maxd) ? nd : -big;
        }
        float& g = nz == 1 ? g1 : (nz == 2 ? g2 : g3);
        g = pos ? fminf(g, nd) : fmaxf(g, nd);
      }
    }
  }
  float cand;
  if (pos) {
    cand = fminf(c, fminf(fminf(fminf(big, g1 + s1), g2 + s2), g3 + s3));
  } else {
    cand = fmaxf(c, fmaxf(fmaxf(fmaxf(-big, g1 - s1), g2 - s2), g3 - s3));
  }
  return fabsf(cand - c) > min_diff ? cand : c;
}

__global__ void __launch_bounds__(NT)
esdf_relax_k2_kernel(float* __restrict__ d, const uint8_t* __restrict__ obs,
                     const uint8_t* __restrict__ upd,
                     const uint8_t* __restrict__ cpos,
                     const uint8_t* __restrict__ cneg,
                     const uint8_t* __restrict__ active,
                     const Schedule sch, float maxd, float min_diff) {
  const int b = blockIdx.x;
  if (!active[b]) return;
  const float big = 1e9f;
  __shared__ float sd[P3];
  __shared__ uint8_t so[P3];
  float* gd = d + (size_t)b * P3;
  const uint8_t* go = obs + (size_t)b * P3;
  const uint8_t* gu = upd + (size_t)b * P3;
  const uint8_t* gp = cpos + (size_t)b * P3;
  const uint8_t* gn = cneg + (size_t)b * P3;
  for (int i = threadIdx.x; i < P3; i += NT) {
    sd[i] = gd[i];
    so[i] = go[i];
  }
  // Thread t owns interior voxels (x, y) = (t & 15, t >> 4) of every z.
  const int x = (threadIdx.x & 15) + 1, y = (threadIdx.x >> 4) + 1;
  const int cell0 = y * P + x;  // cell k of this thread: z = k + 1
  uint32_t umask = 0, codep = 0, coden = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int c0 = cell0 + (k + 1) * P2;
    if (gu[c0]) umask |= 1u << k;
    codep |= (uint32_t)(gp[c0] & 3) << (2 * k);
    coden |= (uint32_t)(gn[c0] & 3) << (2 * k);
  }
  __syncthreads();

  float nv[PER_THREAD];
  for (int s = 0; s < sch.n; ++s) {
    const int stride = sch.stride[s];
    const float s1 = sch.step[s][0], s2 = sch.step[s][1],
                s3 = sch.step[s][2];
    if (stride == 1) {
#pragma unroll 2
      for (int k = 0; k < PER_THREAD; ++k) {
        nv[k] = unit_candidate(sd, so, cell0 + (k + 1) * P2,
                               (umask >> k) & 1u, s1, s2, s3, maxd, min_diff,
                               big);
      }
    } else {
      const uint32_t level = (uint32_t)sch.level[s];
#pragma unroll 1
      for (int k = 0; k < PER_THREAD; ++k) {
        const int c0 = cell0 + (k + 1) * P2;
        const float c = sd[c0];
        const uint32_t code = ((c > 0.0f ? codep : coden) >> (2 * k)) & 3u;
        nv[k] = c;
        if (((umask >> k) & 1u) && code >= level) {
          nv[k] = strided_candidate(sd, so, c0, x, y, k + 1, stride, s1, s2,
                                    s3, maxd, min_diff, big);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) sd[cell0 + (k + 1) * P2] = nv[k];
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int c0 = cell0 + (k + 1) * P2;
    gd[c0] = sd[c0];
  }
}

extern "C" int esdf_relax_k2(void* d, const void* obs, const void* upd,
                             const void* cpos, const void* cneg,
                             const void* active, int n, const Schedule* sch,
                             float maxd, float min_diff, void* stream) {
  if (n <= 0) return 0;
  esdf_relax_k2_kernel<<<n, NT, 0, (cudaStream_t)stream>>>(
      (float*)d, (const uint8_t*)obs, (const uint8_t*)upd,
      (const uint8_t*)cpos, (const uint8_t*)cneg, (const uint8_t*)active,
      *sch, maxd, min_diff);
  return (int)cudaGetLastError();
}
