// The block-walk-and-probe kernel of TSDF allocation (ops/tsdf.py
// allocate_for_rays) for Hopper (sm_90a). Built by
// voxblox_tpu_torch/ops/tsdf_alloc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of the file).
//
// ---- What is computed ----------------------------------------------------
//
// It replaces no TPU kernel: the JAX package discovers the blocks a scan
// needs with XLA ops, a block-level DDA over every lane in lockstep, the
// walk's blocks dilated by one block along each axis into a [7, steps,
// rays] candidate tensor, every candidate hashed and looked up, and the
// missing ones deduplicated through a pending buffer by a scatter-max of
// lane ids. The port's plain version (ops/tsdf.py _allocate_chain ->
// core/layer.allocate_blocks) does the same in PyTorch; on the card that
// chain hashed and looked up 30-67 M candidates a scan, masked or not.
//
// `tsdf_alloc_find`, one thread per ray lane, for lanes that are valid:
//   walk    for i = 0 .. min(num_steps, block_steps - 1) the current block,
//           then the DDA step: the first minimum of t_next, x winning ties
//           over y and z, y over z (raycast.cast_rays on the block-scaled
//           segment; start block, step signs, t_next and t_step come from
//           raycast.dda_start of it);
//   dilate  the 7 candidates of tsdf._DILATE, in order: the block, then
//           +x, -x, +y, -y, +z, -z;
//   lookup  each candidate in the hash table (core/hash.lookup: probes
//           0 .. *max_psl, stopping at the key or an empty cell). Missing
//           means no key, as allocate_blocks' lookup(...) < 0: a key whose
//           slot lies past the pool is present. A candidate that was one of
//           the previous block's present candidates is present still (the
//           table does not change during the pass) and is not looked up
//           again: consecutive blocks share two of their seven;
//   pending a missing candidate atomicMax-es its lane id o*S*R + s*R + r
//           (the flat index of the chain's candidate tensor) into
//           win[hash_words(key) & (pending_size - 1)], and the lane sets
//           the flag win[pending_size]. The buffer then holds, cell by cell,
//           the largest lane id of the missing candidates hashing there:
//           the chain's scatter-max, bit for bit.
// `tsdf_alloc_keys`, one thread per pending cell: decodes the cell's lane
// id (o, s, r), walks ray r s block steps and writes the candidate's key
// words, as allocate_blocks gathers w0[win], w1[win]; (0, empty) and not
// ok where the cell took no lane.
// The host reads the flag once a round and runs the insert on the keys.
//
// ---- What bounds it on this card, and what the design does ---------------
//
// The work is small: per valid lane at most block_steps (14 to 31) block
// steps of a few float compares and adds, 7 candidates a step, and per
// candidate looked up a few dependent 12-byte probe reads of a table that
// stays in L2 (16,384-32,768 cells, 0.2-0.4 MB). The fewest bytes a find
// pass has to move are the valid lanes' per-ray inputs (3 int32 x 3 and
// float x 6 per lane and num_steps: 64 B), one valid byte per lane, the
// table cells it probes (12 B each, each read once) and the pending buffer
// (8 B a cell): ~0.5-2 MB a scan, under a microsecond at 3.35 TB/s. The
// kernel is bound by latency: each probe waits on the walk and the last
// probe, and a warp runs as long as its longest ray. The design keeps every
// candidate in registers (nothing of a candidate is written unless it is
// missing), skips invalid lanes at once, probes a block's neighbours only
// where the previous block had not found them, and launches once a round
// instead of ~15 times a step.
//
// The device functions compile as plain C++ too: the CPU tests build
// csrc/tsdf_alloc_emulate.cpp, which runs both entry points' bodies lane
// by lane and holds the buffer, the flag, the keys and the counters to the
// plain version bit for bit.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define UNROLL _Pragma("unroll")
#else
#define DEV static inline
#define UNROLL
#endif

constexpr int32_t ALLOC_EMPTY_W1 = -1;

// Everything one launch reads and writes (the ctypes structure
// tsdf_alloc.AllocParams mirrors it field for field). Per-ray arrays are
// indexed by lane, [R] or [R, 3] row-major.
struct AllocParams {
  const int32_t* start;      // [R,3] start block
  const int32_t* step;       // [R,3] step signs
  const float* t_next;       // [R,3]
  const float* t_step;       // [R,3]
  const int32_t* num_steps;  // [R] the block walk's L1 length
  const uint8_t* valid;      // [R]
  const int32_t* keys_w0;    // [capacity]
  const int32_t* keys_w1;    // [capacity]
  const int32_t* slot;       // [capacity]
  const int32_t* max_psl;    // [] the table's probe bound
  long long* win;            // [pending_size + 1]: lane ids, then the flag
  int32_t* pend_w0;          // [pending_size], written by tsdf_alloc_keys
  int32_t* pend_w1;          // likewise
  uint8_t* pend_ok;          // likewise
  unsigned long long* counts;  // [4] candidates, probed, missing, probes;
                               // or null
  int32_t n_rays;
  int32_t block_steps;
  int32_t cap_mask;      // table capacity - 1
  int32_t pending_size;  // a power of two
};

struct AllocCounts {
  uint32_t candidates;  // dilated candidates in the walk's mask
  uint32_t probed;      // those looked up in the table
  uint32_t missing;     // those with no key
  uint32_t probes;      // hash cells read
};

DEV uint32_t alloc_hash_words(uint32_t w0, uint32_t w1) {  // hash.hash_words
  uint32_t h = w0 * 0x9E3779B1u;
  h ^= w1 * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// grid.pack_block_index
DEV uint32_t pack_w0(int32_t x, int32_t y) {
  return ((uint32_t)x & 0xFFFFu) | ((((uint32_t)y + 32768u) & 0xFFFFu) << 16);
}

DEV int32_t pack_w1(int32_t z) { return z + 32768; }

// Offset o of tsdf._DILATE along axis a (0, 1, 2): the block itself for
// o = 0, then +x, -x, +y, -y, +z, -z.
DEV int32_t dilate(int32_t o, int32_t a) {
  return (o == 0 || (o - 1) / 2 != a) ? 0 : ((o & 1) ? 1 : -1);
}

// The index in tsdf._DILATE of the offset (dx, dy, dz), or -1.
DEV int32_t dilate_index(int32_t dx, int32_t dy, int32_t dz) {
  if (dx == 0 && dy == 0 && dz == 0) return 0;
  if (dy == 0 && dz == 0 && (dx == 1 || dx == -1)) return dx == 1 ? 1 : 2;
  if (dx == 0 && dz == 0 && (dy == 1 || dy == -1)) return dy == 1 ? 3 : 4;
  if (dx == 0 && dy == 0 && (dz == 1 || dz == -1)) return dz == 1 ? 5 : 6;
  return -1;
}

// Whether the table holds key (w0, w1): core/hash.lookup(...) >= 0.
DEV bool present(const AllocParams& p, uint32_t w0, int32_t w1,
                 int32_t max_psl, AllocCounts& c) {
  const uint32_t h = alloc_hash_words(w0, (uint32_t)w1);
  for (int32_t q = 0; q <= max_psl; ++q) {
    const uint32_t idx = (h + (uint32_t)q) & (uint32_t)p.cap_mask;
    ++c.probes;
    const int32_t k1 = p.keys_w1[idx];
    if (k1 == w1 && p.keys_w0[idx] == (int32_t)w0) return p.slot[idx] >= 0;
    if (k1 == ALLOC_EMPTY_W1) return false;
  }
  return false;
}

// A lane's walk state.
struct BlockWalk {
  int32_t cx, cy, cz, sx, sy, sz;
  float tx, ty, tz, dtx, dty, dtz;
};

DEV BlockWalk walk_start(const AllocParams& p, int32_t r) {
  BlockWalk b;
  b.cx = p.start[3 * r];
  b.cy = p.start[3 * r + 1];
  b.cz = p.start[3 * r + 2];
  b.sx = p.step[3 * r];
  b.sy = p.step[3 * r + 1];
  b.sz = p.step[3 * r + 2];
  b.tx = p.t_next[3 * r];
  b.ty = p.t_next[3 * r + 1];
  b.tz = p.t_next[3 * r + 2];
  b.dtx = p.t_step[3 * r];
  b.dty = p.t_step[3 * r + 1];
  b.dtz = p.t_step[3 * r + 2];
  return b;
}

// The DDA step to the next block: the first minimum of t_next, as
// raycast.cast_rays.
DEV void walk_advance(BlockWalk& b) {
  const bool ax_x = (b.tx <= b.ty) && (b.tx <= b.tz);
  const bool ax_y = !ax_x && (b.ty <= b.tz);
  if (ax_x) {
    b.cx += b.sx;
    b.tx += b.dtx;
  } else if (ax_y) {
    b.cy += b.sy;
    b.ty += b.dty;
  } else {
    b.cz += b.sz;
    b.tz += b.dtz;
  }
}

// One lane's walk: `sink.missing(lane id, pending cell)` for every
// candidate with no key.
template <class Sink>
DEV void alloc_ray(const AllocParams& p, int32_t r, Sink& sink,
                   AllocCounts& c) {
  if (!p.valid[r]) return;
  BlockWalk b = walk_start(p, r);
  const int32_t n = p.num_steps[r];
  const int32_t last = n < p.block_steps - 1 ? n : p.block_steps - 1;
  const int32_t max_psl = *p.max_psl;
  const long long plane = (long long)p.block_steps * p.n_rays;
  const uint32_t pmask = (uint32_t)p.pending_size - 1u;
  int32_t px = 0, py = 0, pz = 0;
  uint32_t prev_hit = 0;  // bit o: the previous block's candidate o present
  for (int32_t i = 0; i <= last; ++i) {
    if (i > 0) walk_advance(b);
    uint32_t hit = 0;
UNROLL
    for (int32_t o = 0; o < 7; ++o) {
      const int32_t x = b.cx + dilate(o, 0), y = b.cy + dilate(o, 1),
                    z = b.cz + dilate(o, 2);
      ++c.candidates;
      if (prev_hit != 0) {
        const int32_t j = dilate_index(x - px, y - py, z - pz);
        if (j >= 0 && ((prev_hit >> j) & 1u)) {
          hit |= 1u << o;
          continue;
        }
      }
      ++c.probed;
      const uint32_t w0 = pack_w0(x, y);
      const int32_t w1 = pack_w1(z);
      if (present(p, w0, w1, max_psl, c)) {
        hit |= 1u << o;
        continue;
      }
      ++c.missing;
      sink.missing((long long)o * plane + (long long)i * p.n_rays + r,
                   alloc_hash_words(w0, (uint32_t)w1) & pmask);
    }
    px = b.cx;
    py = b.cy;
    pz = b.cz;
    prev_hit = hit;
  }
}

// Pending cell i: the key of the candidate whose lane id won it.
DEV void pending_key(const AllocParams& p, int32_t i) {
  const long long lane = p.win[i];
  if (lane < 0) {
    p.pend_w0[i] = 0;
    p.pend_w1[i] = ALLOC_EMPTY_W1;
    p.pend_ok[i] = 0;
    return;
  }
  const long long plane = (long long)p.block_steps * p.n_rays;
  const int32_t o = (int32_t)(lane / plane);
  const long long rest = lane - (long long)o * plane;
  const int32_t s = (int32_t)(rest / p.n_rays);
  const int32_t r = (int32_t)(rest - (long long)s * p.n_rays);
  BlockWalk b = walk_start(p, r);
  for (int32_t k = 0; k < s; ++k) walk_advance(b);
  p.pend_w0[i] = (int32_t)pack_w0(b.cx + dilate(o, 0), b.cy + dilate(o, 1));
  p.pend_w1[i] = pack_w1(b.cz + dilate(o, 2));
  p.pend_ok[i] = 1;
}

#ifdef __CUDACC__

struct AtomicSink {
  long long* win;
  DEV void missing(long long lane, uint32_t cell) {
    atomicMax(win + cell, lane);
  }
};

constexpr int ALLOC_THREADS = 128;

__global__ void __launch_bounds__(ALLOC_THREADS)
tsdf_alloc_kernel(const __grid_constant__ AllocParams p) {
  const int32_t r = (int32_t)(blockIdx.x * ALLOC_THREADS + threadIdx.x);
  AllocCounts c = {0u, 0u, 0u, 0u};
  if (r < p.n_rays) {
    AtomicSink sink{p.win};
    alloc_ray(p, r, sink, c);
    if (c.missing) p.win[p.pending_size] = 1;
  }
  if (p.counts != nullptr) {  // every thread of the warp gets here
    const uint32_t v[4] = {c.candidates, c.probed, c.missing, c.probes};
UNROLL
    for (int k = 0; k < 4; ++k) {
      const uint32_t sum = __reduce_add_sync(0xFFFFFFFFu, v[k]);
      if ((threadIdx.x & 31) == 0 && sum)
        atomicAdd(p.counts + k, (unsigned long long)sum);
    }
  }
}

__global__ void __launch_bounds__(ALLOC_THREADS)
tsdf_alloc_keys_kernel(const __grid_constant__ AllocParams p) {
  const int32_t i = (int32_t)(blockIdx.x * ALLOC_THREADS + threadIdx.x);
  if (i < p.pending_size) pending_key(p, i);
}

extern "C" int tsdf_alloc_params_size(void) {
  return (int)sizeof(AllocParams);
}

extern "C" int tsdf_alloc_find(const AllocParams* p, void* stream) {
  if (p->n_rays <= 0) return 0;
  const int blocks = (p->n_rays + ALLOC_THREADS - 1) / ALLOC_THREADS;
  tsdf_alloc_kernel<<<blocks, ALLOC_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int tsdf_alloc_keys(const AllocParams* p, void* stream) {
  const int blocks = (p->pending_size + ALLOC_THREADS - 1) / ALLOC_THREADS;
  tsdf_alloc_keys_kernel<<<blocks, ALLOC_THREADS, 0,
                           (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
