// Measurement-update pair passes (replace
// dspmap_tpu/ops/pallas/update.py::update_pass1 and ::update_pass2; spec:
// the dense x dense blocks of dspmap_tpu/ops/update.py::measurement_update).
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
