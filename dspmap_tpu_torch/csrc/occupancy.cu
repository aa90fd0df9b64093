// Occupancy pool pass: cull, per-voxel aggregates and systematic resample
// (replaces dspmap_tpu/ops/pallas/occupancy.py::occupancy_pool_pass; spec:
// dspmap_tpu/ops/occupancy.py::_pool_pass_xla, plain version
// dspmap_tpu_torch/ops/occupancy.py::pool_pass_plain).
//
// Bound on the H100: memory by the count (every voxel column is read once --
// flags, weight, px/py/pz, the carried velocity planes -- and written once,
// about 70 bytes a slot against some 140 integer and float operations), but
// what the card actually waits for is latency.  A column is a serial
// recurrence over its S slots (slot-order sums, a weight cumsum, two IEEE
// divisions a slot, a copy-placement sweep) with little to share out, and
// a pool has only V columns: 75,776 to 175,104 for 132 SMs.  One thread a
// column that loads its column slot by slot, each load waited for in turn,
// keeps a handful of 128-byte lines in flight per warp and the memory
// system idle.
//
// Design: a staged tile.  A block owns C neighbouring columns and S * C
// words of shared memory for each plane, tile[plane][slot][column].
//  * Every byte of the tile is requested before any arithmetic: all threads
//    start 16-byte cp.async copies of the tile's rows (C * 4 contiguous bytes
//    each) in two groups -- flags, weight and velocities, which the decision
//    pass reads, then positions and time, which only the placement needs and
//    which go on landing while the first passes compute.  No register holds
//    a byte in flight, and C follows from the slot depth (tile_columns: 64
//    at 18 slots, 32 at 50 and 60) so that several tiles are resident on an
//    SM (seven at 18 and 50 slots, four at 60): one tile's arithmetic and
//    stores overlap its neighbours' loads.
//  * The column's state lives in the tile (a warp's access to one slot is 32
//    neighbouring words: no bank conflict), at every slot depth.  After the
//    decision pass the staged flags word of a slot holds the slot's state
//    instead, so the resample needs no memory of its own: the low half
//    (bit 0 valid, bit 1 kept, bit 2 dropped) belongs to the thread that owns
//    the slot, which ends by writing the final flag there, and the high half
//    holds demand_end, which the placement of every thread of the column
//    searches while the low halves are being rewritten.  The two are
//    accessed as separate 16-bit locations, so no thread reads a location
//    another writes between two barriers; the store masks the high half
//    out.
//  * The block has kThreads = 128 threads whatever C is, so a column has
//    128 / C threads, one for each of its scan blocks: (c, part).  All of
//    them copy; thread (c, 0) makes the decision pass, the one recurrence
//    that runs the whole column; the resample is shared by scan block: thread
//    (c, part) takes the kScanBlock slots of block `part`.  The decision pass
//    leaves the weight cumsum at each block's start (formed exactly as the
//    threshold pass forms it), each block leaves its counts of free slots and
//    extra copies, and a few rows behind the tile carry these between the
//    threads of a column.  At 60 slots and C = 32 that is four warps a tile,
//    one a scan block, where one thread a column left a single warp and the
//    SM's other three schedulers idle.
//  * A column that does not reach resample_min_count skips the resample, and
//    so does a warp without such a column.  In a resampling column the
//    threshold pass forms the block's 16 running sums first; its 32
//    divisions are then independent and overlap in the pipeline.  A filled
//    slot finds its source by a branch-free binary search in the
//    non-decreasing demand_end (a cursor that only advances along the slots
//    does fewer reads but diverges, and measured 8-16% slower) and copies the
//    source's payload inside the tile (a source is a kept slot and a kept
//    slot is never filled, so in place is safe): each input byte is read
//    from device memory once.
//  * The tile goes out as full rows, 16 bytes a thread; the per-voxel
//    vectors as one coalesced row each.
// A pool whose width is not a multiple of 4 (or whose planes are not 16-byte
// aligned) takes the same kernel with 4-byte copies; the last tile of any
// width is guarded by column.
//
// Every float sum associates as the plain version does, because the
// placement thresholds ceil(x/wa - 1/2) turn a different association into
// flag flips: sums run in slot order, the weight cumsum runs in slot order
// within blocks of kScanBlock slots plus the earlier blocks' total (the
// association of the XLA reference), and the per-voxel totals (weight sum,
// velocity sums, static contribution) of 33..64 slots are formed as the first
// ceil(S/2) slots and the rest, each in slot order, then the two added
// (ops/occupancy.py::sum_split).  No FMA contraction (common.cuh).
#include "common.cuh"

namespace {

constexpr int kMaxVel = 3;
constexpr int kMaxPlanes = 6 + kMaxVel;  // flags weight vel* px py pz t
constexpr int kScanBlock = 16;           // = ops/occupancy.py SCAN_BLOCK
// slot state, kept in the staged flags word once the decision pass has run
constexpr unsigned kValid = 1, kKept = 2, kDropped = 4;
constexpr int kStateBits = 16;  // demand_end is the word's high half
constexpr int kThreads = 128;  // of a block, whatever the tile's width
constexpr int kTileBytes = 32 << 10;

// Columns of a tile at S slots: 64 where the seven planes of a moving pool
// then stay within kTileBytes (seven such tiles fit in an SM's 227 KB),
// else 32.  Narrower tiles measured 3-7% faster than wider ones.
__host__ __device__ constexpr int tile_columns(int S) {
  return 7 * S * 64 * 4 <= kTileBytes ? 64 : 32;
}

struct OccArgs {
  // the staged planes in tile order: flags, weight, the n_vel carried
  // velocity planes (what the decision pass reads), then px, py, pz and,
  // where the particle time is recorded, t
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
  uint8_t* omoving;  // [S, V] bool, may be null
  // per-voxel [V] outputs
  float *ws, *n_old, *static_c, *n_valid, *n_culled, *do_rs, *n_dropped,
      *n_filled;
  float* vsum[kMaxVel];
  int V, n_vel, n_planes, resample_min, max_ppv;
  float cull;
};

template <int VEC>
__device__ __forceinline__ void cp_async(int* smem, const int* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Request planes [f0, f1) of the tile at columns [v0, v0 + cols): chunk i of
// a plane is VEC words of slot row i / (C / VEC).  The chunk loops here and
// in store_planes stay rolled: unrolled by the compiler (their trip count is
// a constant) the kernel measured 8-20% slower.
template <int S, int C, int VEC>
__device__ __forceinline__ void stage_planes(const OccArgs& a, int* tile,
                                             int f0, int f1, int v0,
                                             int cols) {
  constexpr int kChunks = C / VEC;  // of a row
#pragma unroll
  for (int f = 0; f < kMaxPlanes; ++f) {
    if (f < f0 || f >= f1) continue;
    const int* src = a.in[f] + v0;
    int* dst = tile + f * S * C;
#pragma unroll 1
    for (unsigned i = threadIdx.x; i < S * kChunks; i += kThreads) {
      const int s = i / kChunks, j = (i % kChunks) * VEC;
      if (j < cols)
        cp_async<VEC>(dst + s * C + j, src + (long long)s * a.V + j);
    }
  }
}

// Write every plane of the tile to its output as full rows.  Plane 0 holds
// the final flag in bit 0 of the slot state.
template <int S, int C, int VEC>
__device__ __forceinline__ void store_planes(const OccArgs& a, const int* tile,
                                             int v0, int cols) {
  constexpr int kChunks = C / VEC;
#pragma unroll
  for (int f = 0; f < kMaxPlanes; ++f) {
    if (f >= a.n_planes) continue;
    int* dst = a.out[f] + v0;
    const int* src = tile + f * S * C;
#pragma unroll 1
    for (unsigned i = threadIdx.x; i < S * kChunks; i += kThreads) {
      const int s = i / kChunks, j = (i % kChunks) * VEC;
      if (j >= cols) continue;
      if constexpr (VEC == 4) {
        int4 x = *reinterpret_cast<const int4*>(src + s * C + j);
        if (f == 0) x.x &= 1, x.y &= 1, x.z &= 1, x.w &= 1;
        *reinterpret_cast<int4*>(dst + (long long)s * a.V + j) = x;
      } else {
        const int x = src[s * C + j];
        dst[(long long)s * a.V + j] = f == 0 ? (x & 1) : x;
      }
    }
  }
}

// smallest power of two above S: the binary search's reach
__host__ __device__ constexpr int search_top(int S) {
  int p = 1;
  while (p <= S) p *= 2;
  return p;
}

// Rows of C words behind the tile through which the threads of a column
// talk: the column's verdict and average weight, the weight cumsum at the
// start of each scan block, each block's count of free slots and of extra
// copies, the column's dropped and filled counts.
template <int S>
struct Exchange {
  static constexpr int kBlocks = (S + kScanBlock - 1) / kScanBlock;
  static constexpr int kResample = 0, kAverage = 1, kBase = 2,
                       kFree = kBase + kBlocks, kExtra = kFree + kBlocks,
                       kDropped = kExtra + kBlocks, kFilled = kDropped + 1,
                       kRows = kFilled + 1;
};

template <int S, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
    occupancy_tile_kernel(OccArgs a) {
  static_assert(S <= 64, "the totals split in two up to 64 slots only");
  constexpr int kSplit = S > 32 ? (S + 1) / 2 : S;  // = sum_split(S)
  constexpr int kTop = search_top(S);
  constexpr int C = tile_columns(S);
  using X = Exchange<S>;
  constexpr int kBlocks = X::kBlocks;
  static_assert(kBlocks == kThreads / C,
                "a column has one thread for each of its scan blocks");
  extern __shared__ __align__(16) int tile[];
  // thread (c, part): column c of the tile, and scan block `part` of the
  // column
  const int c = threadIdx.x % C, part = threadIdx.x / C;
  const int b0 = part * kScanBlock;  // the block's first slot
  const int v0 = blockIdx.x * C, v = v0 + c;
  const int cols = a.V - v0 < C ? a.V - v0 : C;
  const int n_first = 2 + a.n_vel;

  stage_planes<S, C, VEC>(a, tile, 0, n_first, v0, cols);
  cp_async_commit();
  stage_planes<S, C, VEC>(a, tile, n_first, a.n_planes, v0, cols);
  cp_async_commit();

  int* fl = tile + c;  // slot s of this column at [s * C]
  float* w = reinterpret_cast<float*>(tile + S * C) + c;
  int* xch = tile + a.n_planes * S * C + c;  // row r of this column at [r * C]
  const float* vel[kMaxVel];
#pragma unroll
  for (int k = 0; k < kMaxVel; ++k)
    vel[k] = reinterpret_cast<const float*>(tile + (2 + k) * S * C) + c;

  cp_async_wait<1>();
  __syncthreads();

  // ---- decision pass: cull, per-voxel aggregates (one thread a column) ---
  if (part == 0) {
    bool do_rs = false;
    if (v < a.V) {
      const long long V = a.V;
      float ws = 0.0f, stat = 0.0f, vs[kMaxVel] = {0.0f, 0.0f, 0.0f};
      float ws0 = 0.0f, stat0 = 0.0f, vs0[kMaxVel] = {0.0f, 0.0f, 0.0f};
      float base = 0.0f, blk = 0.0f;  // the weight cumsum at block starts
      int count = 0, nold = 0, nculled = 0;
#pragma unroll 6
      for (int s = 0; s < S; ++s) {
        if (s == kSplit) {  // park the first half's totals, start the second
          ws0 = ws, stat0 = stat, ws = 0.0f, stat = 0.0f;
#pragma unroll
          for (int k = 0; k < kMaxVel; ++k) vs0[k] = vs[k], vs[k] = 0.0f;
        }
        const int f0 = fl[s * C];
        const float ww = w[s * C];
        const bool culled = f0 != 0 && ww < a.cull;
        const int f = culled ? 0 : f0;
        const bool valid = f != 0;
        const bool old = valid && f != 3;
        bool mv = false;
#pragma unroll
        for (int k = 0; k < kMaxVel; ++k) {
          if (k < a.n_vel) {
            const float vv = vel[k][s * C];
            mv = mv || vv != 0.0f;
            vs[k] = addf(vs[k], old ? vv : 0.0f);
          }
        }
        const bool moving = old && mv;
        if (a.omoving) a.omoving[s * V + v] = moving ? 1 : 0;
        const float wv = valid ? ww : 0.0f;
        ws = addf(ws, wv);
        stat = addf(stat, (old && !moving) ? ww : 0.0f);
        nold += old ? 1 : 0;
        count += valid ? 1 : 0;
        nculled += culled ? 1 : 0;
        // cull + newborn reset; the final flag where nothing resamples
        fl[s * C] = valid ? kValid : 0;
        // the cumsum as the threshold pass forms it: in slot order within
        // a scan block, plus the earlier blocks' total
        blk = s % kScanBlock == 0 ? wv : addf(blk, wv);
        if (s % kScanBlock == kScanBlock - 1 && s + 1 < S) {
          base = addf(base, blk);
          xch[(X::kBase + (s + 1) / kScanBlock) * C] = __float_as_int(base);
        }
      }
      if constexpr (kSplit < S) {
        ws = addf(ws0, ws);
        stat = addf(stat0, stat);
#pragma unroll
        for (int k = 0; k < kMaxVel; ++k) vs[k] = addf(vs0[k], vs[k]);
      }
      do_rs = count >= a.resample_min;

      a.ws[v] = ws;
      a.n_old[v] = (float)nold;
      a.static_c[v] = stat;
      a.n_valid[v] = (float)count;
      a.n_culled[v] = (float)nculled;
      a.do_rs[v] = do_rs ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxVel; ++k)
        if (k < a.n_vel) a.vsum[k][v] = vs[k];
      if (do_rs) {
        const int n_target = count < a.max_ppv ? count : a.max_ppv;
        xch[X::kAverage * C] = __float_as_int(
            divf(ws, (float)(n_target > 1 ? n_target : 1)));
        xch[X::kDropped * C] = 0;
        xch[X::kFilled * C] = 0;
      } else {
        a.n_dropped[v] = 0.0f;
        a.n_filled[v] = 0.0f;
      }
    }
    xch[X::kResample * C] = do_rs;
  }
  __syncthreads();

  // ---- systematic resample (dsp_dynamic.h:986-1055): thresholds ----------
  const bool do_rs = xch[X::kResample * C];
  const float wa = do_rs ? __int_as_float(xch[X::kAverage * C]) : 0.0f;
  if (do_rs) {
    // block 0 has base 0, and 0 + x == x exactly
    const float base =
        part == 0 ? 0.0f : __int_as_float(xch[(X::kBase + part) * C]);
    float hi[kScanBlock], wv[kScanBlock];
    bool valid[kScanBlock];
    float blk = 0.0f;
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      const int s = b0 + i;
      if (s < S) {
        valid[i] = fl[s * C] & kValid;
        wv[i] = valid[i] ? w[s * C] : 0.0f;
        blk = i == 0 ? wv[i] : addf(blk, wv[i]);
        hi[i] = addf(base, blk);
      }
    }
    int n_free = 0, n_extra = 0;  // of this block; demand_end within it
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      const int s = b0 + i;
      if (s < S) {
        const float lo = subf(hi[i], wv[i]);
        const float g_hi = fmaxf(ceilf(subf(divf(hi[i], wa), 0.5f)), 0.0f);
        const float g_lo = fmaxf(ceilf(subf(divf(lo, wa), 0.5f)), 0.0f);
        const int copies = valid[i] ? (int)g_hi - (int)g_lo : 0;
        const bool kept = valid[i] && copies >= 1;
        const bool dropped = valid[i] && copies == 0;
        n_free += (!valid[i] || dropped) ? 1 : 0;
        n_extra += copies - 1 > 0 ? copies - 1 : 0;
        fl[s * C] = (valid[i] ? kValid : 0) | (kept ? kKept : 0) |
                    (dropped ? kDropped : 0) |
                    ((unsigned)n_extra << kStateBits);
      }
    }
    xch[(X::kFree + part) * C] = n_free;
    xch[(X::kExtra + part) * C] = n_extra;
  }
  __syncthreads();

  // the column's totals and those of the blocks before this thread's;
  // demand_end from within its block to within the column
  const int s1 = b0 + kScanBlock < S ? b0 + kScanBlock : S;
  int total_free = 0, total_extra = 0, free_before = 0, extra_before = 0;
  if (do_rs) {
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      const int n_free = xch[(X::kFree + b) * C],
                n_extra = xch[(X::kExtra + b) * C];
      total_free += n_free;
      total_extra += n_extra;
      if (b < part) free_before += n_free, extra_before += n_extra;
    }
    if (extra_before != 0)
      for (int s = b0; s < s1; ++s) fl[s * C] += extra_before << kStateBits;
  }

  cp_async_wait<0>();
  __syncthreads();

  // ---- placement: new flags and weights, payload of the filled slots -----
  if (do_rs) {
    const int lim = total_extra < total_free ? total_extra : total_free;
    int n_dropped = 0, n_filled = 0;
    int free_rank = free_before, demand_start = extra_before;
#pragma unroll 2
    for (int s = b0; s < s1; ++s) {
      const unsigned st = fl[s * C];
      const bool valid = st & kValid, kept = st & kKept,
                 dropped = st & kDropped;
      const int demand_end = st >> kStateBits;
      const bool is_free = !valid || dropped;
      const bool filled = is_free && free_rank < lim;
      const int extra = demand_end - demand_start;
      int placed = total_free - demand_start;
      placed = placed < 0 ? 0 : (placed > extra ? extra : placed);
      const float unplaced = (float)(extra - placed);
      float nw = kept ? mulf(wa, addf(1.0f, unplaced)) : w[s * C];
      if (filled) nw = wa;
      unsigned nf = valid ? 1 : 0;
      if (dropped) nf = 0;
      if (filled) nf = 1;
      // the low half only: the other threads of the column are searching
      // the high halves
      *reinterpret_cast<unsigned short*>(fl + s * C) = (unsigned short)nf;
      w[s * C] = nw;
      n_dropped += (dropped && !filled) ? 1 : 0;
      n_filled += (filled && !valid) ? 1 : 0;

      // a filled slot copies its source particle, the slot j with
      // j = #{k : demand_end[k] <= free_rank} (demand_end is
      // non-decreasing along the column)
      if (filled) {
        int j = 0;
#pragma unroll
        for (int step = kTop / 2; step > 0; step >>= 1) {
          const int k = j + step;
          // demand_end of slot k - 1: the high half of its state word
          if (k <= S && (int)reinterpret_cast<const unsigned short*>(
                            fl + (k - 1) * C)[1] <= free_rank)
            j = k;
        }
        const int src = j < S ? j : S - 1;
#pragma unroll
        for (int f = 2; f < kMaxPlanes; ++f)
          if (f < a.n_planes)
            tile[(f * S + s) * C + c] = tile[(f * S + src) * C + c];
      }
      free_rank += is_free ? 1 : 0;
      demand_start = demand_end;
    }
    atomicAdd(&xch[X::kDropped * C], n_dropped);
    atomicAdd(&xch[X::kFilled * C], n_filled);
  }
  __syncthreads();
  if (do_rs && part == 0) {
    a.n_dropped[v] = (float)xch[X::kDropped * C];
    a.n_filled[v] = (float)xch[X::kFilled * C];
  }
  store_planes<S, C, VEC>(a, tile, v0, cols);
}

template <int S, int VEC>
int launch(const OccArgs& a, cudaStream_t stream) {
  constexpr int C = tile_columns(S);
  auto kernel = occupancy_tile_kernel<S, VEC>;
  const int smem =
      (a.n_planes * S + Exchange<S>::kRows) * C * (int)sizeof(int);
  // a tile above 48 KB is dynamic shared memory the kernel must be granted
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  const unsigned blocks = (unsigned)((a.V + C - 1) / C);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_aligned(const OccArgs& a, bool wide, cudaStream_t stream) {
  return wide ? launch<S, 4>(a, stream) : launch<S, 1>(a, stream);
}

}  // namespace

// ptrs: the n_planes staged input planes in tile order (flags weight vel0..
//       px py pz [t]) | the n_planes output planes in the same order |
//       omoving (may be 0) | ws n_old static n_valid n_culled do_rs n_dropped
//       n_filled | vsum0 vsum1 vsum2 (beyond n_vel: 0)
// fparams: weight_cull_threshold
// iparams: S V n_vel n_planes resample_min_count max_particles_per_voxel
DSPMAP_API int dspmap_occupancy_pool_pass(const uint64_t* p, const float* f,
                                          const int* ip, void* stream) {
  OccArgs a = {};
  const int S = ip[0];
  a.V = ip[1];
  a.n_vel = ip[2];
  a.n_planes = ip[3];
  a.resample_min = ip[4];
  a.max_ppv = ip[5];
  a.cull = f[0];
  if (a.V == 0) return 0;
  if (a.n_vel < 0 || a.n_vel > kMaxVel || a.n_planes < 5 + a.n_vel ||
      a.n_planes > 6 + a.n_vel)
    return (int)cudaErrorInvalidValue;
  bool wide = a.V % 4 == 0;  // 16-byte copies: every plane aligned too
  for (int k = 0; k < a.n_planes; ++k) {
    a.in[k] = dptr<const int>(p, k);
    a.out[k] = dptr<int>(p, a.n_planes + k);
    wide = wide && (p[k] | p[a.n_planes + k]) % 16 == 0;
  }
  const int q = 2 * a.n_planes;
  a.omoving = dptr<uint8_t>(p, q);
  a.ws = dptr<float>(p, q + 1);
  a.n_old = dptr<float>(p, q + 2);
  a.static_c = dptr<float>(p, q + 3);
  a.n_valid = dptr<float>(p, q + 4);
  a.n_culled = dptr<float>(p, q + 5);
  a.do_rs = dptr<float>(p, q + 6);
  a.n_dropped = dptr<float>(p, q + 7);
  a.n_filled = dptr<float>(p, q + 8);
  for (int k = 0; k < kMaxVel; ++k) a.vsum[k] = dptr<float>(p, q + 9 + k);
  switch (S) {
    case 18:
      return launch_aligned<18>(a, wide, (cudaStream_t)stream);
    case 50:
      return launch_aligned<50>(a, wide, (cudaStream_t)stream);
    case 60:
      return launch_aligned<60>(a, wide, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
