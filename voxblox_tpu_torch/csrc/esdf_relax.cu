// K1 and K2: ESDF 26-neighbour relaxation for Hopper (sm_90a): K1 the
// unit-stride schedule, K2 a schedule with strides > 1. Built by
// voxblox_tpu_torch/ops/esdf_relax.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of the file).
//
// ---- What is computed ----------------------------------------------------
//
// Both replace the TPU kernel voxblox_tpu/ops/pallas/esdf_relax.py
// `_relax_kernel` (launched by `relax_2d`, pallas_call at :395): K1 its
// unit strides, K2 a schedule with a stride k > 1 (`strides` and
// `stride_codes`, :94-99, :123-142, :151-161, :208-230). Same arithmetic,
// voxel for voxel. One Jacobi relaxation per schedule entry, in order, of
// the quasi-Euclidean chamfer (steps 1, sqrt2, sqrt3 voxels, times the
// stride; the step constants arrive from the host, computed exactly as the
// plain version computes them).
//
// Every sweep, a voxel is a source when observed and |d| < max_distance
// (recomputed from the current values), packed by sign: the positive-side
// value or +BIG, the negative-side value or -BIG.
//   Unit sweep: per step group the positive side takes the min and the
//   negative side the max; the sign-flip cap (a positive centre with a
//   valid negative neighbour below d - 2*step, mirrored for negative
//   centres) caps |d| at the step, smallest tripped step winning.
//   Stride-k sweep, k > 1: the source for offset (dx,dy,dz) is the voxel
//   k*(dx,dy,dz) away in the same padded 18^3 cube; a source coordinate
//   outside [0,17] is rejected (the TPU kernel rolls lanes and masks the
//   same coordinates). A positive source counts only where the centre's
//   code_pos reaches the stride's level and value + step < max_distance; a
//   negative one only where code_neg reaches it and value - step >
//   -max_distance. No flip rule. Only the centre's own sign decides which
//   side its candidate takes, so that side alone is evaluated.
// A voxel is written where `upd` holds and |cand - d| > min_diff.
//
// Layout: d f32[N,18,18,18] padded blocks ([z,y,x], the 1-voxel ring holds
// the neighbours' halo and is only read), obs/upd u8 0/1 of the same shape
// (upd is 0 on the ring), active u8[N], for K2 code_pos/code_neg
// u8[N,18,18,18] holding levels 0..3 (level i+1 = the i-th distinct stride
// > 1, ascending), out f32[N,18,18,18]. `d` is only read; every voxel of
// `out` is written: a skipped block is copied through by its CTA, a
// relaxed block's tile is copied as it is loaded and its changed voxels
// are stored at the end. Blocks never read each other (each ring is the
// block's own copy of the halo), so there is no race between CTAs.
//
// Activity gate, per block: a block with active == 0 is copied through.
// The caller sets a block active when it or a 1-ring neighbour changed by
// more than min_diff in the previous outer iteration. Otherwise the
// block's padded state is exactly what its previous launch left, and that
// launch wrote none of its voxels (every write needs |cand - d| >
// min_diff, which would have flagged the block). Codes, obs and upd are
// static across the outer iterations of one update and every sweep is a
// deterministic function of the padded state, so the same schedule writes
// nothing again: skipping gives the values running would. The TPU kernel
// gates per tile of 8 blocks; gating per block gives the same values.
//
// ---- What bounds it on this card, and what the design does ---------------
//
// No products: tensor cores (`wgmma`) have no use here. The work is min,
// max, compare, select and add on f32, one instruction a lane a clock:
// 132 SMs x 128 lanes x 1.98 GHz = 33.45e12 a second (half the data
// sheet's 67 TFLOP/s, which counts an FMA as two).
//
// Operations the function needs per block and unit sweep, by the best
// arrangement known (chip_smoke.py OPS_PER_BLOCK_SWEEP = 416,976, ~102
// per interior voxel):
//   packing, once per padded voxel (each is a source for its neighbours):
//     |d|, < max_distance, & obs, > 0, two ands and two selects for the
//     +-BIG pair, two selects for the trip-test values       18^3 x 10
//   in-plane partial extrema, per padded plane and each of the 4 packed
//     fields, shared by the three centres above, in and below the plane:
//     X = ext(left, right) on 18 rows x 16 columns, Y = ext(up, down),
//     faces-in-plane F = ext(X, Y), diagonals E = ext(X[up], X[down]) on
//     16 x 16                                  18 x 4 x (288 + 3 x 256)
//   recombination per interior voxel and field: faces = ext(F[z],
//     C[z-1], C[z+1]) (2), edges = ext(E[z], F[z-1], F[z+1]) (2), corners
//     = ext(E[z-1], E[z+1]) (1)                          16^3 x 4 x 5
//   finish, per interior voxel: 3 step adds + 3 mins, 3 step subs + 3
//     maxes, centre sign + min + max + select, per group threshold c-2s,
//     c+2s, two compares, side select, per group cap |cand|, compare,
//     and, +-step select, select, write test sub, |.|, compare, & upd,
//     select                                               16^3 x 49
// (The count of the first design, 26 x 4 extrema per voxel, was 685,008.)
// This kernel computes F and E from the 3x3 window directly (6 extrema a
// field and plane instead of 4.1), ~111 per interior voxel, and runs
// against the shared-memory pipe rather than the lanes (see 2 below).
// A strided sweep needs the packing, one gate test per interior voxel
// (own-sign code, compare with the level, and upd: 3) and, per voxel whose
// gate is open, for each neighbour inside the cube the window test and the
// running extremum (add step, compare, select, min/max: 4) and the finish
// (3 step adds, 3 min/max, min/max with the centre, subtract, |.|,
// compare, select: 11).
// Bytes: d read and out written for all N blocks (4 + 4 bytes a padded
// voxel); obs and upd (and the code cubes) read for active blocks only.
// At 512 blocks, 251 active, 4 sweeps: 0.419 G operations (12.5 us) against
// 26.8 MB (8.0 us at 3.35 TB/s): operation-bound, narrowly.
//
// The design:
//   1. Pack once per sweep. The CTA keeps a shared-memory tile of the
//      18^3 padded voxels' four packed fields (93,312 B, dynamic): the
//      positive-side value or +BIG and the negative-side value or -BIG
//      (array `side`, float2), and the two flip-test values with the
//      sentinels on the losing side (array `flip`, float2). A reader takes
//      two 8-byte loads a neighbour, no compare, no select. The current
//      distances of a thread's own voxels sit in shared-memory slots of
//      its own (16 KB, static: not a tile, nobody else reads them), their
//      obs/upd bits in two registers. After a sweep each thread re-packs
//      the voxels it changed, in place, between the two barriers of the
//      Jacobi step.
//   2. Slide along z. A thread owns one (x, y) column and walks it. Per
//      padded plane it loads the 3x3 window once and forms C (the voxel),
//      F (4 in-plane faces) and E (4 in-plane diagonals); three planes'
//      partials stay in registers and recombine exactly (min and max are
//      exact in any order) into the three step groups of the centre
//      between them: 18 loads a plane instead of 52 a voxel. Consecutive
//      threads read consecutive float2: no bank conflicts, and the
//      shared-memory pipe (128 B a clock an SM) is what the sweep runs
//      against: 9 x 16 B x 18/16 planes = 162 B a voxel.
//   3. Fill the card. 256 threads, two CTAs an SM (2 x 108 KB of the 227
//      KB; at most 128 registers a thread). At the small buckets (~250
//      active blocks) that is one wave of two blocks on most SMs.
//      Splitting a block's z-range over 512 threads (8-voxel columns, one
//      CTA an SM) was built and measured: it lost 13-37% at every bucket
//      (one CTA of 16 warps stalls at its barriers, two CTAs of 8 hide
//      each other's), so one shape serves all. Keeping a column's 16
//      distances in registers through all phases was 5-7% faster for K1
//      but made K2 spill: they wait in shared memory instead.
//   4. Strided sweeps read one float of `side` k voxels away: at 8 bytes
//      a thread, two shared-memory wavefronts a warp (one float of a
//      float4 tile took four, as much as the whole float4). The x and y
//      bounds are a 9-bit mask per thread and sweep, the z bound per
//      plane; the centre's side is folded into a sign so both sides run
//      one min chain; the window test runs once per group; a thread's
//      2-bit codes for its voxels' own sign are one word in shared memory;
//      strides 2, 4 and 8 are compiled in (the 26 source offsets are
//      immediates of the loads: 6% on K2), any other runs the same code
//      with a run-time stride; no array is indexed at run time, so there
//      is no stack frame.
//   5. Work that the data does not need is skipped: an active block none
//      of whose voxels may be written is copied through (one vote over
//      the `upd` bits; the incremental update marks every block active in
//      its single outer iteration but confines `upd` to the changed
//      region); a column with no such voxel loads nothing; when a sweep
//      changed no voxel of the block, the following sweeps of the same
//      stride are identical functions of the same state and are skipped
//      (the first barrier of the step carries the vote).
//
// The device functions below compile as plain C++ too: the CPU tests build
// csrc/esdf_relax_emulate.cpp, which runs `relax_block` thread by thread
// and phase by phase and holds it to the plain PyTorch version bit for bit.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#else
#include <math.h>
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
static inline float2 make_float2(float x, float y) { return float2{x, y}; }
static inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
#define DEV static inline
#endif

constexpr int P = 18;  // padded block side
constexpr int P2 = P * P;
constexpr int P3 = P * P * P;
constexpr int ZC = 16;        // voxels of a thread's column: all interior z
constexpr int THREADS = 256;  // one thread per interior (x, y)
constexpr float BIG = 1e9f;
constexpr int MAX_SCHEDULE = 16;

// The relaxations of one launch. K1 reads n and step[0] only.
struct Schedule {
  int n;
  int stride[MAX_SCHEDULE];
  int level[MAX_SCHEDULE];  // 0 at stride 1
  float step[MAX_SCHEDULE][3];
};

// Shared memory of a CTA. The packed tile is two arrays of 18^3 float2:
// `side` holds a voxel as a source (.x positive-side value or +BIG, .y
// negative-side value or -BIG), `flip` the flip tests' values (.x the
// valid negative value or +BIG, .y the valid positive value or -BIG). A
// unit sweep reads both; a strided sweep reads one float of `side`, at a
// stride of 8 bytes across threads (two shared-memory wavefronts a warp
// where one float of a float4 tile would take four). `own` holds the
// threads' current distances (voxel k of thread t at k * 256 + t: no bank
// conflicts) and `codes` one word a thread (K2: 2 bits a voxel, the
// admissibility level for the voxel's own sign, which no sweep changes);
// only their thread reads and writes them, and they are objects of their
// own, so the compiler may move the tile's loads across their stores.
struct Shared {
  float2* side;
  float2* flip;
  float* own;
  uint32_t* codes;
};
constexpr int TILE_BYTES = 2 * P3 * 8;  // 93,312: side, then flip

// A thread's column: the 16 interior voxels (x, y, 1 + k), k = 0..15, of
// thread x + 16 y (interior coordinates). Registers are what limits the
// kernels (two CTAs an SM leave 128 a thread, and the unit sweep wants
// them for three planes of partials), so a column's state in registers is
// two words of per-voxel bits: bit k of a half-word belongs to voxel k.
struct Column {
  uint32_t masks;  // low half: may be written (upd); high half: observed
  uint32_t marks;  // low half: written by the last sweep; high half: by any
};

// Tile index of voxel 0 of thread `tid`'s column; voxel k is P2 * k on.
DEV int column_cell(int tid) {
  return P2 + ((tid >> 4) + 1) * P + (tid & 15) + 1;
}

// Packs voxel `i` of the tile from its distance.
DEV void pack(const Shared& sm, int i, float v, bool observed, float maxd) {
  const bool ok = observed && fabsf(v) < maxd;
  const bool pos = v > 0.0f;
  const float dp = (ok && pos) ? v : BIG;
  const float dn = (ok && !pos) ? v : -BIG;
  sm.side[i] = make_float2(dp, dn);
  sm.flip[i] = make_float2(dn > -BIG * 0.5f ? dn : BIG,
                           dp < BIG * 0.5f ? dp : -BIG);
}

// Voxel `i` of the tile: .x, .y its `side`, .z, .w its `flip`.
DEV float4 packed(const Shared& sm, int i) {
  const float2 s = sm.side[i], f = sm.flip[i];
  return make_float4(s.x, s.y, f.x, f.y);
}

// Field-wise extremum of two packed values: min, max, min, max.
DEV float4 ext(const float4 a, const float4 b) {
  return make_float4(fminf(a.x, b.x), fmaxf(a.y, b.y), fminf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// One padded plane seen from a column: the voxel, its 4 in-plane face
// neighbours, its 4 in-plane diagonals.
struct Plane {
  float4 c, f, e;
};

DEV Plane plane_partials(const Shared& sm, int i) {
  Plane p;
  p.c = packed(sm, i);
  p.f = ext(ext(packed(sm, i - P), packed(sm, i + P)),
            ext(packed(sm, i - 1), packed(sm, i + 1)));
  p.e = ext(ext(packed(sm, i - P - 1), packed(sm, i - P + 1)),
            ext(packed(sm, i + P - 1), packed(sm, i + P + 1)));
  return p;
}

// The new value of a centre `c` of a unit sweep from the partials of the
// plane below, its own and the one above; `take` says whether it passes
// the write test (the caller knows `upd`).
DEV float unit_candidate(float c, const Plane& lo, const Plane& mid,
                         const Plane& hi, float s1, float s2, float s3,
                         float min_diff, bool& take) {
  const float4 g1 = ext(ext(mid.f, lo.c), hi.c);  // faces
  const float4 g2 = ext(ext(mid.e, lo.f), hi.f);  // edges
  const float4 g3 = ext(lo.e, hi.e);              // corners
  const bool pos = c > 0.0f;
  const float bp = fminf(fminf(fminf(BIG, g1.x + s1), g2.x + s2), g3.x + s3);
  const float bn =
      fmaxf(fmaxf(fmaxf(-BIG, g1.y - s1), g2.y - s2), g3.y - s3);
  float cand = pos ? fminf(c, bp) : fmaxf(c, bn);
  const float sg = pos ? 1.0f : -1.0f;
  // Flip caps, largest step first so the smallest tripped step wins.
  const bool tr3 = pos ? (g3.z < c - 2.0f * s3) : (g3.w > c + 2.0f * s3);
  const bool tr2 = pos ? (g2.z < c - 2.0f * s2) : (g2.w > c + 2.0f * s2);
  const bool tr1 = pos ? (g1.z < c - 2.0f * s1) : (g1.w > c + 2.0f * s1);
  if (tr3 && fabsf(cand) > s3) cand = sg * s3;
  if (tr2 && fabsf(cand) > s2) cand = sg * s2;
  if (tr1 && fabsf(cand) > s1) cand = sg * s1;
  take = fabsf(cand - c) > min_diff;
  return cand;
}

// One unit sweep of a column: reads the tile, writes the column's own
// distances. Returns the mask of voxels it changed.
DEV uint32_t unit_sweep(const Column& col, const Shared& sm, int tid,
                        float s1, float s2, float s3, float min_diff) {
  const uint32_t upd = col.masks & 0xffffu;
  if (upd == 0) return 0;
  float* own = sm.own + tid;
  const int cell0 = column_cell(tid);
  Plane lo = plane_partials(sm, cell0 - P2);
  Plane mid = plane_partials(sm, cell0);
  uint32_t chg = 0;
#pragma unroll
  for (int k = 0; k < ZC; ++k) {
    const Plane hi = plane_partials(sm, cell0 + (k + 1) * P2);
    if ((upd >> k) & 1u) {
      bool take;
      const float cand = unit_candidate(own[k * THREADS], lo, mid, hi, s1,
                                        s2, s3, min_diff, take);
      if (take) {
        own[k * THREADS] = cand;
        chg |= 1u << k;
      }
    }
    lo = mid;
    mid = hi;
  }
  return chg;
}

// One stride-k sweep (k > 1) of a column. The centre's side is folded
// into a sign: with sg = +1 for a positive centre and -1 otherwise, sg *
// (its side's field) is a positive value or +BIG for either side, the
// negative side's max becomes a min and `v - step > -max_distance` becomes
// `sg * v + step < max_distance` (negation is exact, so the values are the
// plain version's). The window test is monotone in the source value and
// the step is one per group, so it is applied to the group's minimum.
// K is the stride where the compiler may know it (2, 4, 8: the 26 source
// offsets are then immediates of the loads), or 0 for `k_any`.
template <int K>
DEV uint32_t strided_sweep(const Column& col, const Shared& sm, int tid,
                           int k_any, uint32_t level, float s1, float s2,
                           float s3, float maxd, float min_diff) {
  const uint32_t upd = col.masks & 0xffffu;
  if (upd == 0) return 0;
  const uint32_t code = sm.codes[tid];
  const int k = K ? K : k_any;
  float* own = sm.own + tid;
  // In-cube tests of the sources, hoisted: bit 3 * (dy + 1) + dx + 1 says
  // whether the source column (x + k dx, y + k dy) lies in the cube.
  const int x = (tid & 15) + 1, y = (tid >> 4) + 1;
  uint32_t xy = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if ((unsigned)(x + k * dx) < (unsigned)P &&
          (unsigned)(y + k * dy) < (unsigned)P) {
        xy |= 1u << (3 * (dy + 1) + dx + 1);
      }
    }
  }
  const float* fields =
      reinterpret_cast<const float*>(sm.side + column_cell(tid));
  uint32_t chg = 0;
#pragma unroll
  for (int j = 0; j < ZC; ++j) {
    if (!((upd >> j) & 1u) || ((code >> (2 * j)) & 3u) < level) continue;
    const float c = own[j * THREADS];
    const bool pos = c > 0.0f;
    const float sg = pos ? 1.0f : -1.0f;
    // .x of the source for a positive centre, .y for a negative one.
    const float* f = fields + 2 * j * P2 + (pos ? 0 : 1);
    const int z = j + 1;
    float g[3] = {BIG, BIG, BIG};
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
      if ((unsigned)(z + k * dz) >= (unsigned)P) continue;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int nz = (dx != 0) + (dy != 0) + (dz != 0);
          if (nz == 0) continue;
          if ((xy >> (3 * (dy + 1) + dx + 1)) & 1u) {
            g[nz - 1] = fminf(g[nz - 1],
                              sg * f[2 * k * (dz * P2 + dy * P + dx)]);
          }
        }
      }
    }
    g[0] = g[0] + s1 < maxd ? g[0] : BIG;
    g[1] = g[1] + s2 < maxd ? g[1] : BIG;
    g[2] = g[2] + s3 < maxd ? g[2] : BIG;
    const float m = fminf(
        sg * c, fminf(fminf(fminf(BIG, g[0] + s1), g[1] + s2), g[2] + s3));
    const float cand = sg * m;
    if (fabsf(cand - c) > min_diff) {
      own[j * THREADS] = cand;
      chg |= 1u << j;
    }
  }
  return chg;
}

// A block's 1,458 float4 from `src` to `dst` (a padded block is 16-byte
// aligned), thread `tid` taking every 256th.
DEV void copy_block(const float* src, float* dst, int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = tid; i < P3 / 4; i += THREADS) d4[i] = s4[i];
}

// The column's `upd` bits: all a block needs to know whether it has
// anything to do.
DEV void init_column(Column& col, int tid, const uint8_t* gu) {
  const int cell0 = column_cell(tid);
  col.masks = col.marks = 0;
#pragma unroll
  for (int k = 0; k < ZC; ++k) {
    if (gu[cell0 + k * P2]) col.masks |= 1u << k;
  }
}

// Load phase: the block's distances go to `out` as they are and into the
// tile packed (thread `tid` takes every 256th voxel); the column's own
// distances, obs bits and (K2) own-sign codes go to their places.
template <bool STRIDED>
DEV void load_block(Column& col, const Shared& sm, int tid, const float* gd,
                    const uint8_t* go, const uint8_t* gp, const uint8_t* gn,
                    float* gout, float maxd) {
#pragma unroll 4
  for (int i = tid; i < P3; i += THREADS) {
    const float v = gd[i];
    gout[i] = v;
    pack(sm, i, v, go[i] != 0, maxd);
  }
  const int cell0 = column_cell(tid);
  uint32_t code = 0;
#pragma unroll
  for (int k = 0; k < ZC; ++k) {
    const int i = cell0 + k * P2;
    const float v = gd[i];
    sm.own[k * THREADS + tid] = v;
    if (go[i]) col.masks |= 0x10000u << k;
    if (STRIDED) code |= (uint32_t)((v > 0.0f ? gp[i] : gn[i]) & 3) << (2 * k);
  }
  if (STRIDED) sm.codes[tid] = code;
}

// Write phase of the Jacobi step: re-pack the voxels the sweep changed.
DEV void repack(Column& col, const Shared& sm, int tid, float maxd) {
  const int cell0 = column_cell(tid);
#pragma unroll 4
  for (int k = 0; k < ZC; ++k) {
    if ((col.marks >> k) & 1u) {
      pack(sm, cell0 + k * P2, sm.own[k * THREADS + tid],
           (col.masks >> (16 + k)) & 1u, maxd);
    }
  }
  col.marks |= col.marks << 16;
}

DEV void store_column(const Column& col, const Shared& sm, int tid,
                      float* gout) {
  const int cell0 = column_cell(tid);
#pragma unroll 4
  for (int k = 0; k < ZC; ++k) {
    if ((col.marks >> (16 + k)) & 1u) {
      gout[cell0 + k * P2] = sm.own[k * THREADS + tid];
    }
  }
}

// One stride-k sweep of the block (entry `s` of the schedule), its barrier
// and its vote.
template <int K, class Cta>
DEV bool strided_step(Cta& cta, const Shared& sm, const Schedule& sch, int s,
                      float maxd, float min_diff) {
  return cta.each_any([&](int tid, Column& col) {
    const uint32_t chg = strided_sweep<K>(
        col, sm, tid, sch.stride[s], (uint32_t)sch.level[s], sch.step[s][0],
        sch.step[s][1], sch.step[s][2], maxd, min_diff);
    col.marks = (col.marks & 0xffff0000u) | chg;
    return chg != 0;
  });
}

// One active block, all its sweeps. `cta` runs a phase for every thread
// of the CTA: `each` ends in a barrier, `each_any` in a barrier that
// returns whether any thread's phase returned true, `last` in none. A
// phase either reads the tile or writes the thread's own cells of it,
// never both, so the sweeps are exact Jacobi steps.
template <bool STRIDED, class Cta>
DEV void relax_block(Cta& cta, const Shared& sm, const float* gd,
                     const uint8_t* go, const uint8_t* gu, const uint8_t* gp,
                     const uint8_t* gn, float* gout, const Schedule& sch,
                     float maxd, float min_diff) {
  const bool work = cta.each_any([&](int tid, Column& col) {
    init_column(col, tid, gu);
    return col.masks != 0;
  });
  if (!work) {  // no voxel of the block may be written: copy through
    cta.last([&](int tid, Column&) { copy_block(gd, gout, tid); });
    return;
  }
  cta.each([&](int tid, Column& col) {
    load_block<STRIDED>(col, sm, tid, gd, go, gp, gn, gout, maxd);
  });
  int s = 0;
  while (s < sch.n) {
    const int stride = STRIDED ? sch.stride[s] : 1;
    bool any;
    if (stride == 1) {
      const int e = STRIDED ? s : 0;
      any = cta.each_any([&](int tid, Column& col) {
        const uint32_t chg =
            unit_sweep(col, sm, tid, sch.step[e][0], sch.step[e][1],
                       sch.step[e][2], min_diff);
        col.marks = (col.marks & 0xffff0000u) | chg;
        return chg != 0;
      });
    } else if (stride == 2) {
      any = strided_step<2>(cta, sm, sch, s, maxd, min_diff);
    } else if (stride == 4) {
      any = strided_step<4>(cta, sm, sch, s, maxd, min_diff);
    } else if (stride == 8) {
      any = strided_step<8>(cta, sm, sch, s, maxd, min_diff);
    } else {
      any = strided_step<0>(cta, sm, sch, s, maxd, min_diff);
    }
    ++s;
    if (!any) {
      // Nothing changed: the same sweep again would change nothing.
      while (s < sch.n && (!STRIDED || sch.stride[s] == sch.stride[s - 1])) {
        ++s;
      }
      continue;
    }
    cta.each([&](int tid, Column& col) { repack(col, sm, tid, maxd); });
  }
  cta.last([&](int tid, Column& col) { store_column(col, sm, tid, gout); });
}

#ifdef __CUDACC__

struct DeviceCta {
  Column col;
  template <class F>
  DEV void each(F f) {
    f((int)threadIdx.x, col);
    __syncthreads();
  }
  template <class F>
  DEV bool each_any(F f) {
    return __syncthreads_or(f((int)threadIdx.x, col)) != 0;
  }
  template <class F>
  DEV void last(F f) {
    f((int)threadIdx.x, col);
  }
};

template <bool STRIDED>
DEV void relax_cta(const float* d, const uint8_t* obs, const uint8_t* upd,
                   const uint8_t* cpos, const uint8_t* cneg,
                   const uint8_t* active, float* out, const Schedule& sch,
                   float maxd, float min_diff) {
  extern __shared__ float4 tile[];  // TILE_BYTES, dynamic
  __shared__ float own[ZC * THREADS];
  __shared__ uint32_t codes[THREADS];
  const size_t base = (size_t)blockIdx.x * P3;
  if (!active[blockIdx.x]) {
    copy_block(d + base, out + base, (int)threadIdx.x);
    return;
  }
  const Shared sm = {reinterpret_cast<float2*>(tile),
                     reinterpret_cast<float2*>(tile) + P3, own, codes};
  DeviceCta cta;
  relax_block<STRIDED>(cta, sm, d + base, obs + base, upd + base,
                       STRIDED ? cpos + base : nullptr,
                       STRIDED ? cneg + base : nullptr, out + base, sch, maxd,
                       min_diff);
}

// 256 threads, two CTAs an SM: 128 registers a thread at most.
__global__ void __launch_bounds__(THREADS, 2)
esdf_relax_k1_kernel(const float* __restrict__ d,
                     const uint8_t* __restrict__ obs,
                     const uint8_t* __restrict__ upd,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ out,
                     const __grid_constant__ Schedule sch, float maxd,
                     float min_diff) {
  relax_cta<false>(d, obs, upd, nullptr, nullptr, active, out, sch, maxd,
                   min_diff);
}

__global__ void __launch_bounds__(THREADS, 2)
esdf_relax_k2_kernel(const float* __restrict__ d,
                     const uint8_t* __restrict__ obs,
                     const uint8_t* __restrict__ upd,
                     const uint8_t* __restrict__ cpos,
                     const uint8_t* __restrict__ cneg,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ out,
                     const __grid_constant__ Schedule sch, float maxd,
                     float min_diff) {
  relax_cta<true>(d, obs, upd, cpos, cneg, active, out, sch, maxd, min_diff);
}

template <class K>
static int allow_tile(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// Once after loading: both kernels may use the tile's dynamic shared
// memory. Returns the first cudaError, 0 when all is set.
extern "C" int esdf_relax_init(void) {
  const int err = allow_tile(esdf_relax_k1_kernel);
  return err ? err : allow_tile(esdf_relax_k2_kernel);
}

// CTAs of a kernel that fit on one SM (for the records), or -1.
extern "C" int esdf_relax_ctas_per_sm(int strided) {
  int ctas = -1;
  const cudaError_t err =
      strided ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &ctas, esdf_relax_k2_kernel, THREADS, TILE_BYTES)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &ctas, esdf_relax_k1_kernel, THREADS, TILE_BYTES);
  return err == cudaSuccess ? ctas : -1;
}

extern "C" int esdf_relax_k1(const void* d, const void* obs, const void* upd,
                             const void* active, void* out, int n,
                             int inner_sweeps, float s1, float s2, float s3,
                             float maxd, float min_diff, void* stream) {
  if (n <= 0) return 0;
  Schedule sch = {};
  sch.n = inner_sweeps;
  sch.step[0][0] = s1;
  sch.step[0][1] = s2;
  sch.step[0][2] = s3;
  esdf_relax_k1_kernel<<<n, THREADS, TILE_BYTES, (cudaStream_t)stream>>>(
      (const float*)d, (const uint8_t*)obs, (const uint8_t*)upd,
      (const uint8_t*)active, (float*)out, sch, maxd, min_diff);
  return (int)cudaGetLastError();
}

extern "C" int esdf_relax_k2(const void* d, const void* obs, const void* upd,
                             const void* cpos, const void* cneg,
                             const void* active, void* out, int n,
                             const Schedule* sch, float maxd, float min_diff,
                             void* stream) {
  if (n <= 0) return 0;
  esdf_relax_k2_kernel<<<n, THREADS, TILE_BYTES, (cudaStream_t)stream>>>(
      (const float*)d, (const uint8_t*)obs, (const uint8_t*)upd,
      (const uint8_t*)cpos, (const uint8_t*)cneg, (const uint8_t*)active,
      (float*)out, *sch, maxd, min_diff);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
