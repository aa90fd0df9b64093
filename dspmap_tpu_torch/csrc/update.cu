// Measurement-update pair passes (replace
// dspmap_tpu/ops/pallas/update.py::update_pass1 and ::update_pass2; spec:
// the dense x dense blocks of dspmap_tpu/ops/update.py::measurement_update),
// and the spill tier's pair sums (the blocks that
// dspmap_tpu/ops/update.py::measurement_update calls B2 and B4; no
// pallas_call: XLA fuses them there), described above their kernels below.
//
//   pass 1: out[r, m] = sum_s w[r, s] * c3 * exp(-|x_s - z_m|^2 / 2)
//   pass 2: out[r, s] = sum_m c3 * exp(-|x_s - z_m|^2 / 2) * cinv[r, m]
//
// with c3 = pi^-3/2 and coordinates pre-scaled by 1/sigma by the wrapper.
// In both passes d2 is formed from coordinate differences (as in the Pallas
// kernel): the matmul form |a|^2 + |b|^2 - 2ab, and the tensor cores with
// it, loses |a|^2 * 2^-24 at world coordinates of several metres over sigma.
//
// Bound on the H100: the exponentials and the instructions around them.  A
// pass is rows x S_t x CK pair terms (8.3M at the flagship, 29M at the
// multi-neighbor preset) against 0.5 to 30 MB of input.  Each term needs one
// ex2 on the special-function units (16 a clock an SM, against 128 float
// operations), so the card's least time for a pass is the pair count over
// 132 x 16 ex2 a clock, above its bytes over the memory rate at the
// flagship and static shapes and a little under them at the multi-neighbor
// shape (30 MB, 9 us).
//
// Both passes share one term (pair_term): three subtractions, a multiply,
// two fused multiply-adds, the scale by -log2(e)/2, one ex2.approx and the
// accumulating multiply-add with a weight staged beside the coordinates;
// its relative error (2^-22 from ex2, 2^-23 from the scaled exponent) is far
// inside the bar of rtol 2e-5 against float64.  Neither pass uses atomics:
// every sum runs in a fixed order and two calls give the same bits.
//
// Pass 1 (K3a): a thread holds T = 2 points of one pyramid row in
// registers, loaded straight from device memory (consecutive threads take
// consecutive points, so loads and stores coalesce), and walks the row's
// S_t particles in order.  A block of 256 threads covers as many rows as
// its threads reach, flat over (row, point group), and stages each of those
// rows' particles once in shared memory as (x, y, z, c3 * w): one 16-byte
// broadcast load a particle serves the thread's T points.  The points' loads
// are issued before the staging barrier; the index math is 32-bit (64-bit
// divisions cost 11-15% at the multi-neighbor shape, whose threads have 32
// terms).  A row with few points (CK <= 10 at S_t = 64) would make a block
// of 256 threads reach more rows than 48 KB of shared memory stage; such a
// block covers whole rows, as many as fit, and its surplus threads leave
// after the barrier.  T = 2 is the one value measured inside the aims at all
// three path shapes.  Measured and dropped (PERF.md section 6): 1, 4 and 8
// points a thread, and 2 or 4 lanes a point group joined by a shuffle tree.
//
// Pass 2 (K3b): one thread a particle would leave the card with 16 to 73
// thousand threads of 288 to 400 dependent terms each.  So the point axis is
// cut across lanes: a group of 16 lanes shares 4 particles of one row, lane
// j sums the points j, j + 16, .. in order (4 independent chains a lane,
// each point read from shared memory once for all 4), and the group's
// partial sums meet in a fixed xor-shuffle tree.  A block of 256 threads
// takes as many pyramid rows as give every group its particles (one at
// S_t = 64 and 32, four at S_t = 16) and stages their points once, laid out
// as (zx, zy, zz, c3 * cinv) a point: one 16-byte shared load a point.
// Measured and dropped (PERF.md section 6): 4, 8 and 32 lanes a particle,
// 1, 2 and 8 particles a lane, and staging the points as flat 16-byte words.
#include "common.cuh"

namespace {

constexpr float kC3 = 0.17958712212516656f;  // (1/sqrt(pi))^3
// g = c3 * exp(-d2 / 2) = c3 * 2^(-d2 * log2(e) / 2): one ex2 on the
// special-function unit
constexpr float kNegHalfLog2e = -0.72134752044448170368f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc + b.w * 2^(-log2(e)/2 * |a - b.xyz|^2): pass 1 passes a point as a and
// a staged particle as b, pass 2 a particle and a staged point (a - b and
// b - a round alike, so d2 has the same bits either way)
__device__ __forceinline__ float pair_term(float ax, float ay, float az,
                                           float4 b, float acc) {
  const float dx = ax - b.x, dy = ay - b.y, dz = az - b.z;
  const float d2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  return fmaf(ex2(kNegHalfLog2e * d2), b.w, acc);
}

// ---------------------------------------------------------------- pass 1

constexpr int kPass1Threads = 256;
constexpr int kPass1Points = 2;  // points a thread (T)

struct Pass1Args {
  const float* pos;  // [R, S_t, 3] scaled
  const float* w;    // [R, S_t]
  const float* pts;  // [R, CK, 3] scaled
  float* out;        // [R, CK]
  int rows, st, ck;
  unsigned groups;   // point groups a row: ceil(CK / T)
  unsigned items;    // rows * groups, under 2^31
  unsigned per_block;  // items a block, at most kPass1Threads
  int span;          // rows a block stages at most
};

// Item i of the grid (row i / groups, group j = i % groups) owns the points
// j, j + groups, .. (T of them, those under CK live) of its row; block b
// takes the items [b * per_block, (b + 1) * per_block).
__global__ void __launch_bounds__(kPass1Threads) pass1_kernel(Pass1Args a) {
  constexpr int T = kPass1Points;
  extern __shared__ float4 sp[];  // [rows of the block][S_t]: (x, y, z, c3 w)
  const unsigned first = blockIdx.x * a.per_block;
  const int r0 = (int)(first / a.groups);

  // the thread's points first, so that their loads are in flight while the
  // block stages its particles; a thread without an item loads the block's
  // first item's points and leaves after the barrier
  const unsigned i = first + threadIdx.x;
  const bool live = threadIdx.x < a.per_block && i < a.items;
  const unsigned item = live ? i : first;
  const int row = (int)(item / a.groups);
  const int j = (int)(item - (unsigned)row * a.groups);
  const float* pts = a.pts + (long long)row * a.ck * 3;
  float zx[T], zy[T], zz[T], acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int m = min(j + t * (int)a.groups, a.ck - 1);
    zx[t] = pts[3 * m];
    zy[t] = pts[3 * m + 1];
    zz[t] = pts[3 * m + 2];
    acc[t] = 0.0f;
  }
  {
    const int n = min(a.span, a.rows - r0) * a.st;
    const float* pos = a.pos + (long long)r0 * a.st * 3;
    const float* w = a.w + (long long)r0 * a.st;
    for (int k = threadIdx.x; k < n; k += kPass1Threads)
      sp[k] = make_float4(pos[3 * k], pos[3 * k + 1], pos[3 * k + 2],
                          mulf(kC3, w[k]));
  }
  __syncthreads();
  if (!live) return;
  const float4* prt = sp + (row - r0) * a.st;
#pragma unroll 4
  for (int s = 0; s < a.st; ++s) {
    const float4 b = prt[s];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = pair_term(zx[t], zy[t], zz[t], b, acc[t]);
  }
  float* out = a.out + (long long)row * a.ck;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int m = j + t * (int)a.groups;
    if (m < a.ck) out[m] = acc[t];
  }
}

// ptrs: pos w pts out;  iparams: rows S_t CK
int launch_pass1(const uint64_t* p, const int* ip, void* stream) {
  constexpr int T = kPass1Points;
  Pass1Args a;
  a.pos = dptr<const float>(p, 0);
  a.w = dptr<const float>(p, 1);
  a.pts = dptr<const float>(p, 2);
  a.out = dptr<float>(p, 3);
  a.rows = ip[0];
  a.st = ip[1];
  a.ck = ip[2];
  if (a.rows == 0) return 0;
  if (a.rows < 0 || a.st < 1 || a.ck < 1) return (int)cudaErrorInvalidValue;
  a.groups = (unsigned)((a.ck + T - 1) / T);
  const long long items = (long long)a.rows * a.groups;
  if (items + kPass1Threads >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  a.items = (unsigned)items;
  // rows whose particles fit in the 48 KB of shared memory a block has
  // without asking
  const int fit = (48 * 1024) / (a.st * (int)sizeof(float4));
  // 256 items a block reach over at most this many rows
  a.per_block = kPass1Threads;
  a.span = min(a.rows, (kPass1Threads - 1) / (int)a.groups + 2);
  if (a.span > fit) {  // few points a row: whole rows a block
    const int whole = min(fit, kPass1Threads / (int)a.groups);
    if (whole < 1) return (int)cudaErrorInvalidValue;
    a.per_block = (unsigned)(whole * (int)a.groups);
    a.span = whole;
  }
  const size_t smem = sizeof(float4) * (size_t)a.span * a.st;
  const unsigned blocks = (a.items + a.per_block - 1) / a.per_block;
  pass1_kernel<<<blocks, kPass1Threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- pass 2

constexpr int kPass2Threads = 256;
constexpr int kLanes = 16;     // lanes that share a particle's points (G)
constexpr int kParticles = 4;  // particles a lane carries at once (T)

struct Pass2Args {
  const float* pos;   // [R, S_t, 3] scaled
  const float* cinv;  // [R, CK]
  const float* pts;   // [R, CK, 3] scaled
  float* out;         // [R, S_t]
  int rows, st, ck;
  int rb;             // pyramid rows a block
};

// kLanes lanes share kParticles particles of one row: lane j sums the points
// j, j + kLanes, .. in order, then the partial sums meet in a fixed xor tree.
__global__ void __launch_bounds__(kPass2Threads) pass2_kernel(Pass2Args a) {
  constexpr int G = kLanes, T = kParticles;
  extern __shared__ float4 sp[];  // [rb][CK]: (zx, zy, zz, c3 * cinv)
  const int r0 = blockIdx.x * a.rb;
  const int nr = min(a.rb, a.rows - r0);
  {
    const float* pts = a.pts + (long long)r0 * a.ck * 3;
    const float* cv = a.cinv + (long long)r0 * a.ck;
    for (int m = threadIdx.x; m < nr * a.ck; m += blockDim.x)
      sp[m] = make_float4(pts[3 * m], pts[3 * m + 1], pts[3 * m + 2],
                          mulf(kC3, cv[m]));
  }
  __syncthreads();

  const int group = threadIdx.x / G, j = threadIdx.x % G;
  constexpr int kGroups = kPass2Threads / G;
  const int tiles = (a.st + T - 1) / T;  // groups of T particles a row
  const int items = nr * tiles;
  // every lane of a warp walks the same number of items: the shuffles
  // below need all 32
  for (int first = 0; first < items; first += kGroups) {
    const bool live = first + group < items;
    const int item = live ? first + group : items - 1;
    const int rl = item / tiles, s0 = (item - rl * tiles) * T;
    const float* pos = a.pos + ((long long)(r0 + rl) * a.st) * 3;
    float px[T], py[T], pz[T], acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int s = min(s0 + t, a.st - 1);
      px[t] = pos[3 * s];
      py[t] = pos[3 * s + 1];
      pz[t] = pos[3 * s + 2];
      acc[t] = 0.0f;
    }
    const float4* row = sp + rl * a.ck;
#pragma unroll 4
    for (int m = j; m < a.ck; m += G) {
      const float4 z = row[m];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = pair_term(px[t], py[t], pz[t], z, acc[t]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o /= 2) {
#pragma unroll
      for (int t = 0; t < T; ++t)
        acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    }
    if (live && j == 0) {
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (s0 + t < a.st)
          a.out[(long long)(r0 + rl) * a.st + s0 + t] = acc[t];
    }
  }
}

// ptrs: pos cinv pts out;  iparams: rows S_t CK
int launch_pass2(const uint64_t* p, const int* ip, void* stream) {
  Pass2Args a;
  a.pos = dptr<const float>(p, 0);
  a.cinv = dptr<const float>(p, 1);
  a.pts = dptr<const float>(p, 2);
  a.out = dptr<float>(p, 3);
  a.rows = ip[0];
  a.st = ip[1];
  a.ck = ip[2];
  if (a.rows == 0) return 0;
  if (a.rows < 0 || a.st < 1 || a.ck < 1) return (int)cudaErrorInvalidValue;
  // rows a block: enough that every group of lanes has particles, within
  // the 48 KB of shared memory a block has without asking
  const int tiles = (a.st + kParticles - 1) / kParticles;
  const int fit = (48 * 1024) / (a.ck * (int)sizeof(float4));
  if (fit < 1) return (int)cudaErrorInvalidValue;
  a.rb = max(1, min(min(kPass2Threads / kLanes / tiles, fit), a.rows));
  const size_t smem = sizeof(float4) * (size_t)a.rb * a.ck;
  const int blocks = (a.rows + a.rb - 1) / a.rb;
  pass2_kernel<<<blocks, kPass2Threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ spill tier
//
// The spill tier holds the in-FOV particles beyond the first S_t of their
// pyramid: a buffer of Psp rows (particle_spill_capacity) whose valid rows
// are a prefix, in candidate order (not grouped by pyramid), `count` of
// them, read on the card.  Each particle pairs with the CK dense points of
// its pyramid's neighbourhood and with the Ks spill points of every spill
// cell (an observation cell beyond its Ko dense points, Yc of them) within
// the neighbour radius of its pyramid.  The plain version (ops/update.py::
// spill_pass1_plain / spill_pass2_plain) forms those pairs as matrices
// padded to the capacity: [Psp, CK] and [Psp, Yc * Ks], most of them
// masked.  These kernels visit only the pairs that are there.
//
//   pass 1 (spill_cz_kernel), a block a target: for pyramid p
//     out[p, m]  = sum over valid i with pyr[i] = p of w[i] g(x_i, z[p, m])
//   and for spill cell y (open and within the radius of pyr[i])
//     cout[y, k] = sum over valid i adjacent to y of w[i] g(x_i, s[y, k])
//   pass 2 (spill_factor_kernel), a warp a spill particle:
//     out[i] = sum_m g(x_i, z[p_i, m]) cinv[p_i, m]
//            + sum over y adjacent to p_i, k of g(x_i, s[y, k]) ccinv[y, k]
//   (the second sum only where the configuration has spill cells); rows
//   past `count` get 0.  Each block first lists the open spill cells in
//   cell order in shared memory.
//
// Pass 1's block scans the counted prefix of the buffer in tiles of 1,024
// rows (four a thread; the next tile's pyramids load while this one is
// summed), compacts the rows that pair with its target into shared memory
// in buffer order (a block-wide exclusive scan of the threads' counts;
// two buffers, so one barrier a tile suffices, and a tile without such
// rows needs no second), and its threads sum those particles into their
// points.
// A thread holds T <= 4 points of its target (T independent sums), and
// L lanes share a group of points, lane l taking the tile's particles l,
// l + L, ..: at radius 1, 72 groups of 4 of a pyramid's 288 points and 3
// lanes, 34 groups of 2 of a spill cell's 68 points and 7 lanes.  The
// lanes' sums meet in lane order at the end.  Every sum runs in a fixed
// order with no atomics, so two calls give the same bits, and the launch
// shape depends on the capacity alone: blocks past the count return from
// the scan at once, and no host sync reads the count.
//
// Bound on the H100: the pair terms, one ex2 each (K3's pair_term): some
// 14 M in each pass at large_urban's 45 k spill particles (7 us at
// 132 x 16 ex2 a clock); the operands are 1.8 MB.  What the design pays
// beyond that is pass 1's scans of the prefix (n_pyr + Yc blocks, 4 bytes
// a row, from L2) and pass 2's loads of each particle's points from L2.

constexpr int kSpillThreads = 256;
constexpr int kSpillScan = 4;                           // rows a thread tests
constexpr int kSpillTile = kSpillThreads * kSpillScan;  // rows a scan step
constexpr int kSpillPoints = 4;  // points a thread at most: M <= 1024
constexpr int kSpillWarps = kSpillThreads / 32;

struct SpillGrid {
  const float* pos;            // [Psp, 3] scaled
  const int* pyr;              // [Psp] (n_pyr on invalid rows)
  const int* count;            // valid rows: a prefix of the buffer
  const float* pts;            // [n_pyr, CK, 3] scaled
  const float* cpts;           // [Yc, Ks, 3] scaled
  const int* cells;            // [Yc] (n_pyr on unused cells)
  const unsigned char* cmask;  // [Yc] bool
  int rows, n_pyr, ck, yc, ks, width, radius;
};

struct SpillCzArgs {
  SpillGrid g;
  const float* w;  // [Psp] weight
  float* out;      // [n_pyr, CK]
  float* cout;     // [Yc, Ks]
};

struct SpillSumArgs {
  SpillGrid g;
  const float* cinv;   // [n_pyr, CK]
  const float* ccinv;  // [Yc, Ks]
  float* out;          // [Psp]
};

__device__ __forceinline__ int spill_rows(const SpillGrid& g) {
  return max(0, min(*g.count, g.rows));
}

__device__ __forceinline__ bool spill_adjacent(int p, int h, int v,
                                               const SpillGrid& g) {
  return abs(p / g.width - h) <= g.radius && abs(p % g.width - v) <= g.radius;
}

__global__ void __launch_bounds__(kSpillThreads)
spill_cz_kernel(SpillCzArgs a) {
  // the tile's rows that pair with the target, (x, y, z, c3 w), and the
  // warps' counts: two of each, so that one barrier a tile suffices
  // between writing a tile's rows and summing them
  __shared__ float4 part[2][kSpillTile];
  __shared__ int warp_n[2][kSpillWarps];
  __shared__ float lanes_acc[kSpillThreads * kSpillPoints];
  const SpillGrid& g = a.g;
  const bool is_cell = blockIdx.x >= (unsigned)g.n_pyr;
  const int target = is_cell ? blockIdx.x - g.n_pyr : blockIdx.x;
  const int M = is_cell ? g.ks : g.ck;
  const float* pts = is_cell ? g.cpts + (long long)target * g.ks * 3
                             : g.pts + (long long)target * g.ck * 3;
  float* out = is_cell ? a.cout + (long long)target * g.ks
                       : a.out + (long long)target * g.ck;
  int th = 0, tv = 0;
  bool open = true;
  if (is_cell) {
    const int c = min(g.cells[target], g.n_pyr - 1);
    th = c / g.width;
    tv = c % g.width;
    open = g.cmask[target] != 0;
  }
  const int n = open ? spill_rows(g) : 0;

  // T points a thread, about 64 groups of them (G), and L lanes a group,
  // as many as the block holds: lane l takes the tile's rows l, l + L, ..
  // So a thread carries T independent sums, and a crowded target's rows
  // are split L ways rather than walked by one thread in a chain
  const int T = min(kSpillPoints, max(1, (M + 63) / 64));
  const int G = (M + T - 1) / T;
  const int L = max(1, kSpillThreads / G);
  const int lane = threadIdx.x / G, grp = threadIdx.x - lane * G;
  const bool active = lane < L;
  float zx[kSpillPoints], zy[kSpillPoints], zz[kSpillPoints],
      acc[kSpillPoints];
#pragma unroll
  for (int t = 0; t < kSpillPoints; ++t) {
    const int m = min(grp + t * G, M - 1);
    zx[t] = pts[3 * m];
    zy[t] = pts[3 * m + 1];
    zz[t] = pts[3 * m + 2];
    acc[t] = 0.0f;
  }

  // the thread's rows of a tile: their pyramids, -1 past the count; the
  // next tile's are loaded while this one is summed
  auto load = [&](int base, int* pyr) {
#pragma unroll
    for (int k = 0; k < kSpillScan; ++k) {
      const int i = base + threadIdx.x * kSpillScan + k;
      pyr[k] = i < n ? min(g.pyr[i], g.n_pyr - 1) : -1;
    }
  };
  int cur[kSpillScan], nxt[kSpillScan];
#pragma unroll
  for (int k = 0; k < kSpillScan; ++k) nxt[k] = -1;
  load(0, cur);
  const int wid = threadIdx.x / 32, wl = threadIdx.x % 32;
  for (int base = 0, buf = 0; base < n; base += kSpillTile, buf ^= 1) {
    unsigned hits = 0;
    int c = 0;
#pragma unroll
    for (int k = 0; k < kSpillScan; ++k) {
      const int p = cur[k];
      const bool hit = p >= 0 && (is_cell ? spill_adjacent(p, th, tv, g)
                                          : p == target);
      hits |= (unsigned)hit << k;
      c += hit;
    }
    if (base + kSpillTile < n) load(base + kSpillTile, nxt);
    // block-wide exclusive scan of the counts: the rows keep buffer order
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (wl >= o) incl += y;
    }
    if (wl == 31) warp_n[buf][wid] = incl;
    __syncthreads();
    int at = incl - c, total = 0;
#pragma unroll
    for (int k = 0; k < kSpillWarps; ++k) {
      const int x = warp_n[buf][k];
      at += k < wid ? x : 0;
      total += x;
    }
    if (total > 0) {
      const int first = base + threadIdx.x * kSpillScan;
#pragma unroll
      for (int k = 0; k < kSpillScan; ++k) {
        if (hits >> k & 1u) {
          const int i = first + k;
          part[buf][at++] = make_float4(g.pos[3 * i], g.pos[3 * i + 1],
                                        g.pos[3 * i + 2], mulf(kC3, a.w[i]));
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int s = lane; s < total; s += L) {
          const float4 b = part[buf][s];
#pragma unroll
          for (int t = 0; t < kSpillPoints; ++t)
            if (t < T) acc[t] = pair_term(zx[t], zy[t], zz[t], b, acc[t]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSpillScan; ++k) cur[k] = nxt[k];
  }

  // the lanes' sums meet in lane order
  if (L > 1) {
    if (active) {
#pragma unroll
      for (int t = 0; t < kSpillPoints; ++t)
        lanes_acc[threadIdx.x * kSpillPoints + t] = acc[t];
    }
    __syncthreads();
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kSpillPoints; ++t) {
      const int m = grp + t * G;
      if (t < T && m < M) {
        float s = acc[t];
        for (int l = 1; l < L; ++l)
          s += lanes_acc[(l * G + grp) * kSpillPoints + t];
        out[m] = s;
      }
    }
  }
}

// a warp a row of the buffer, rows strided over the grid
__global__ void __launch_bounds__(kSpillThreads)
spill_factor_kernel(SpillSumArgs a) {
  // the open spill cells, in cell order: index, h, v
  extern __shared__ int open_cells[];
  __shared__ int n_open;
  const SpillGrid& g = a.g;
  if (threadIdx.x < 32) {  // one warp compacts them, keeping their order
    int at = 0;
    for (int y0 = 0; y0 < g.yc; y0 += 32) {
      const int y = y0 + threadIdx.x;
      const bool open = y < g.yc && g.cmask[y] != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, open);
      if (open) {
        const int k = at + __popc(ball & ((1u << threadIdx.x) - 1u));
        const int c = min(g.cells[y], g.n_pyr - 1);
        open_cells[3 * k] = y;
        open_cells[3 * k + 1] = c / g.width;
        open_cells[3 * k + 2] = c % g.width;
      }
      at += __popc(ball);
    }
    if (threadIdx.x == 0) n_open = at;
  }
  __syncthreads();
  const int n = spill_rows(g), n_cells = n_open;
  const int wl = threadIdx.x % 32;
  const int stride = gridDim.x * kSpillWarps;
  for (int i = blockIdx.x * kSpillWarps + threadIdx.x / 32; i < g.rows;
       i += stride) {
    if (i >= n) {
      if (wl == 0) a.out[i] = 0.0f;
      continue;
    }
    const int p = min(g.pyr[i], g.n_pyr - 1);
    const float px = g.pos[3 * i], py = g.pos[3 * i + 1], pz = g.pos[3 * i + 2];
    const float* z = g.pts + (long long)p * g.ck * 3;
    const float* cv = a.cinv + (long long)p * g.ck;
    float dense = 0.0f;
#pragma unroll 4
    for (int m = wl; m < g.ck; m += 32)
      dense = pair_term(px, py, pz,
                        make_float4(z[3 * m], z[3 * m + 1], z[3 * m + 2],
                                    mulf(kC3, cv[m])),
                        dense);
    float spill = 0.0f;
    const int h = p / g.width, v = p % g.width;
    for (int k = 0; k < n_cells; ++k) {
      if (abs(open_cells[3 * k + 1] - h) > g.radius ||
          abs(open_cells[3 * k + 2] - v) > g.radius)
        continue;
      const int y = open_cells[3 * k];
      const float* s = g.cpts + (long long)y * g.ks * 3;
      const float* sc = a.ccinv + (long long)y * g.ks;
#pragma unroll 4
      for (int j = wl; j < g.ks; j += 32)
        spill = pair_term(px, py, pz,
                          make_float4(s[3 * j], s[3 * j + 1], s[3 * j + 2],
                                      mulf(kC3, sc[j])),
                          spill);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      dense += __shfl_xor_sync(0xffffffffu, dense, o);
      spill += __shfl_xor_sync(0xffffffffu, spill, o);
    }
    if (wl == 0) a.out[i] = g.yc > 0 ? dense + spill : dense;
  }
}

// ptrs: pos pyr count pts cpts cells cmask, then the pass's own;
// iparams: Psp n_pyr CK Yc Ks width radius
int spill_grid(const uint64_t* p, const int* ip, SpillGrid* g) {
  g->pos = dptr<const float>(p, 0);
  g->pyr = dptr<const int>(p, 1);
  g->count = dptr<const int>(p, 2);
  g->pts = dptr<const float>(p, 3);
  g->cpts = dptr<const float>(p, 4);
  g->cells = dptr<const int>(p, 5);
  g->cmask = dptr<const unsigned char>(p, 6);
  g->rows = ip[0];
  g->n_pyr = ip[1];
  g->ck = ip[2];
  g->yc = ip[3];
  g->ks = ip[4];
  g->width = ip[5];
  g->radius = ip[6];
  if (g->rows < 0 || g->n_pyr < 1 || g->ck < 1 || g->yc < 0 || g->width < 1 ||
      g->radius < 0 || g->ck > kSpillThreads * kSpillPoints ||
      (g->yc > 0 && (g->ks < 1 || g->ks > kSpillThreads * kSpillPoints)) ||
      g->yc > 2048)  // pass 2 lists the open cells in 12 bytes each
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ptrs: the grid's, then w out cout
int launch_spill_pass1(const uint64_t* p, const int* ip, void* stream) {
  SpillCzArgs a;
  if (const int rc = spill_grid(p, ip, &a.g)) return rc;
  a.w = dptr<const float>(p, 7);
  a.out = dptr<float>(p, 8);
  a.cout = dptr<float>(p, 9);
  const unsigned blocks = (unsigned)(a.g.n_pyr + a.g.yc);
  spill_cz_kernel<<<blocks, kSpillThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: the grid's, then cinv ccinv out
int launch_spill_pass2(const uint64_t* p, const int* ip, void* stream) {
  SpillSumArgs a;
  if (const int rc = spill_grid(p, ip, &a.g)) return rc;
  a.cinv = dptr<const float>(p, 7);
  a.ccinv = dptr<const float>(p, 8);
  a.out = dptr<float>(p, 9);
  if (a.g.rows == 0) return 0;
  // a fixed grid, as the capacity gives it: a row a warp up to 65,536 rows
  const int blocks = min((a.g.rows + kSpillWarps - 1) / kSpillWarps, 8192);
  const size_t smem = sizeof(int) * 3 * (size_t)max(a.g.yc, 1);
  spill_factor_kernel<<<blocks, kSpillThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: pos w pts out;  iparams: rows S_t CK
DSPMAP_API int dspmap_update_pass1(const uint64_t* p, const float*, const int* ip,
                                   void* stream) {
  return launch_pass1(p, ip, stream);
}

// ptrs: pos cinv pts out;  iparams: rows S_t CK
DSPMAP_API int dspmap_update_pass2(const uint64_t* p, const float*, const int* ip,
                                   void* stream) {
  return launch_pass2(p, ip, stream);
}

// ptrs: pos pyr count pts cpts cells cmask w out cout;
// iparams: Psp n_pyr CK Yc Ks width radius
DSPMAP_API int dspmap_spill_pass1(const uint64_t* p, const float*, const int* ip,
                                  void* stream) {
  return launch_spill_pass1(p, ip, stream);
}

// ptrs: pos pyr count pts cpts cells cmask cinv ccinv out;
// iparams: Psp n_pyr CK Yc Ks width radius
DSPMAP_API int dspmap_spill_pass2(const uint64_t* p, const float*, const int* ip,
                                  void* stream) {
  return launch_spill_pass2(p, ip, stream);
}
