// Segmented-scan pair of the compact layout (replaces
// dspmap_tpu/ops/pallas/segscan.py::seg_scans_pallas; spec:
// dspmap_tpu_torch/ops/compact.py::seg_cumsum_plain and fill_from_end_plain).
//
// Per column c (a [P] array of f32, bool/u8 or i32, read as f32):
//   hi[c]  = segmented inclusive prefix sum, runs starting at is_start:
//            for d = 1, 2, .. < reach:  s = b ? s : s + s[i-d];  b |= b[i-d]
//            (fill (0, true) before row 0);
//   tot[c] (c < n_tot) = each run's value at its end row, filled backward:
//            for d = 1, 2, .. < reach:  t = k ? t : t[i+d];  k |= k[i+d]
//            starting from t = hi[c], k = is_end (fill (0, false) past row P-1).
// The forward steps add the same operands in the same order as the plain
// version, so hi is bit-equal to it.  Any other association (a tree over a
// warp, a decoupled look-back) moves the run sums by an ulp and the
// resample's ceil(x/wa - 1/2) boundaries with them.  The flags and the
// backward fill hold no arithmetic, so they are taken in closed form:
//   before step d, b[i] = "a run starts in rows (i - d, i]";
//   tot[i] = hi[first end row in [i, i + reach)], or hi[i + reach - 1]
//            where there is none (0 past row P-1).
//
// Bound on the H100: neither the bytes (the largest call of a frame moves
// 8.7 MB, 2.6 us at 3.35 TB/s) nor the adds, but the chain of dependent
// steps behind each row and the loads in front of it.
//
// Design, reach 16 and 32 (every path of the repo): a row's hi depends on at
// most the 31 rows before it and its tot on the hi of the 31 rows after it,
// one warp's width.  A warp walks a strip of kStrip windows of 32 rows of one column,
// one row a lane.  A step of the recurrence is one __shfl_sync inside the
// window; the lanes below d take the state the previous window had before
// that same step, which the warp keeps in registers (one value a step), so
// no row of a strip is computed twice and nothing goes through shared memory
// or a barrier.
// The flags are bit tests on the __ballot_sync masks of this window's and
// the previous window's start flags; tot of a window is two shuffles of this
// and the next window's hi at an index found with __ffs on the end masks,
// one window behind the forward walk.  A strip starts with the window before
// it (its states before step d are right on the lanes >= 32 - d, the only
// ones read) and, for tot, ends with the window after it.  All the loads of
// a strip are started before its first step; a strip whose walk lies inside
// [0, P) takes a path without bounds tests.  Three windows a strip and one
// column a warp measured best (PERF.md section 6): shorter chains and more
// warps outweigh walking two more windows than a strip holds.
//
// Every other reach, 1..8 and 64..512 (no path of the repo): one block per
// (tile of kTile rows, column) stages rows [a - (reach-1), b + (reach-1)) of
// its tile [a, b) in shared memory and runs the steps over the whole buffer,
// double-buffered, with a barrier a step.  The choice between the two forms
// is by reach alone.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr int kMaxReach = 512;
constexpr unsigned kFull = 0xffffffffu;

enum ColType { kF32 = 0, kU8 = 1, kI32 = 2 };

struct ScanArgs {
  const void* x[kMaxCols];  // C columns [P]
  const uint8_t* start;     // [P] run starts
  const uint8_t* end;       // [P] run ends (live rows only)
  float* hi;                // [C, P]
  float* tot;               // [n_tot, P]
  int type[kMaxCols];       // ColType of each column
  int C, P, n_tot, reach;
};

// the column's value as f32: exact for bool/u8, round-to-nearest for i32
// (the plain version's .to(float32))
__device__ __forceinline__ float load_col(const void* p, int type, long long i) {
  if (type == kU8) return (float)static_cast<const uint8_t*>(p)[i];
  if (type == kI32) return __int2float_rn(static_cast<const int*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// --------------------------------------------------- reach 16 and 32

constexpr int kWarpThreads = 128;  // four strips a block
constexpr int kStrip = 3;          // windows of 32 rows a strip
constexpr int kWalk = kStrip + 2;  // with the window before and the one after

// the walk's windows of one column as f32 (0 outside [0, P)); `col` points
// at the lane's row of window 0
template <bool EDGE, typename T>
__device__ __forceinline__ void load_walk(const T* col, unsigned in, int last,
                                          float* x) {
#pragma unroll
  for (int k = 0; k < kWalk; ++k) {
    if (k > last) break;
    x[k] = (!EDGE || (in >> k & 1u)) ? (float)col[32 * k] : 0.0f;
  }
}

// One warp's walk over a strip of one column, STEPS = log2(reach), 4 or 5.
// EDGE: some row of the walk lies outside [0, P); such rows read as the
// recurrences' own fill (0, start, no end) and are not written.
template <int STEPS, bool EDGE>
__device__ __forceinline__ void walk_strip(const ScanArgs& a, int row0,
                                           int lane, int c) {
  constexpr int kReach = 1 << STEPS;
  constexpr unsigned kReachMask = kReach >= 32 ? kFull : (1u << kReach) - 1u;
  const int row = row0 + lane;  // the lane's row of window 0
  const bool with_tot = c < a.n_tot;
  const int last = with_tot ? kStrip + 1 : kStrip;  // the window after feeds tot

  // every load of the walk is started before its first step
  unsigned in = 0, ms[kWalk], me[kWalk];
#pragma unroll
  for (int k = 0; k < kWalk; ++k) {
    if (k > last) break;
    bool here = true;
    if (EDGE) {
      here = row + 32 * k >= 0 && row + 32 * k < a.P;
      in |= (unsigned)here << k;
    }
    ms[k] = __ballot_sync(kFull, !here || (a.start + row)[32 * k] != 0);
    me[k] = with_tot
        ? __ballot_sync(kFull, here && (a.end + row)[32 * k] != 0) : 0u;
  }
  float x[kWalk];
  const void* col = a.x[c];
  if (a.type[c] == kF32)
    load_walk<EDGE>(static_cast<const float*>(col) + row, in, last, x);
  else if (a.type[c] == kU8)
    load_walk<EDGE>(static_cast<const uint8_t*>(col) + row, in, last, x);
  else
    load_walk<EDGE>(static_cast<const int*>(col) + row, in, last, x);

  float before[STEPS];  // the previous window's state before step j
#pragma unroll
  for (int j = 0; j < STEPS; ++j) before[j] = 0.0f;
  float hi_prev = 0.0f;
  float* hi = a.hi + (long long)c * a.P + row;
  float* tot = a.tot + (long long)c * a.P + row;

#pragma unroll
  for (int k = 0; k < kWalk; ++k) {
    if (k > last) break;
    // the start flags of rows i - 31 .. i in bits 0 .. 31
    const unsigned starts =
        __funnelshift_rc(k > 0 ? ms[k - 1] : kFull, ms[k], lane + 1);
    float cur = x[k];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      constexpr int kLastStep = STEPS - 1;
      const int d = 1 << j;
      // the window before the strip is walked for its states before each
      // step, so its last step is left out
      if (k == 0 && j == kLastStep) {
        before[j] = cur;
        break;
      }
      // lane l is read by lane (l + d) % 32: of this window if that lane
      // lies above l, else of the next window
      const float give = lane + d < 32 ? cur : before[j];
      const float got = __shfl_sync(kFull, give, (lane - d) & 31);
      before[j] = cur;
      // a run starts in rows (i - d, i] (bits 32 - d .. 31): keep
      cur = starts >= (1u << (32 - d)) ? cur : addf(cur, got);
    }
    if (k >= 1 && k <= kStrip && (!EDGE || (in >> k & 1u))) hi[32 * k] = cur;
    if (with_tot && k >= 2) {
      // tot of the window before: hi at the first end row in
      // [i, i + reach), or at row i + reach - 1.  Its end flags of rows
      // i .. i + 31 from bit 0 up:
      const unsigned ends =
          __funnelshift_rc(me[k - 1], me[k], lane) & kReachMask;
      const int from = lane + (ends ? __ffs(ends) - 1 : kReach - 1);
      const float v0 = __shfl_sync(kFull, hi_prev, from & 31);
      const float v1 = __shfl_sync(kFull, cur, from & 31);
      if (!EDGE || (in >> (k - 1) & 1u))
        tot[32 * (k - 1)] = from < 32 ? v0 : v1;
    }
    hi_prev = cur;
  }
}

// one warp a (strip, column): blockIdx.y is the column
template <int STEPS>
__global__ void __launch_bounds__(kWarpThreads)
segscan_warp_kernel(const __grid_constant__ ScanArgs a) {
  const int lane = threadIdx.x & 31;
  const int strip = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  // window k of the walk holds rows [row0 + 32k, row0 + 32k + 32): k = 0 is
  // the window before the strip, k = kStrip + 1 the one after it
  const int row0 = (strip * kStrip - 1) * 32;
  if (row0 + 32 >= a.P) return;  // the whole warp leaves
  if (row0 >= 0 && row0 + 32 * kWalk <= a.P)
    walk_strip<STEPS, false>(a, row0, lane, blockIdx.y);
  else
    walk_strip<STEPS, true>(a, row0, lane, blockIdx.y);
}

template <int STEPS>
void launch_warp(const ScanArgs& a, cudaStream_t stream) {
  const int windows = (a.P + 31) / 32;
  const int strips = (windows + kStrip - 1) / kStrip;
  const int per_block = kWarpThreads / 32;
  const dim3 grid((strips + per_block - 1) / per_block, a.C);
  segscan_warp_kernel<STEPS><<<grid, kWarpThreads, 0, stream>>>(a);
}

// --------------------------------------- reach 1 .. 8 and 64 .. 512

constexpr int kTile = 1024;
constexpr int kBuf = kTile + 2 * (kMaxReach - 1);
constexpr int kTileThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
segscan_tile_kernel(const __grid_constant__ ScanArgs a) {
  __shared__ float sv[2][kBuf];
  __shared__ uint8_t sf[2][kBuf];
  const int c = blockIdx.y;
  const int h = a.reach - 1;
  const long long a0 = (long long)blockIdx.x * kTile;
  const int tile = (int)min((long long)kTile, a.P - a0);
  const long long base = a0 - h;  // global row of buffer slot 0
  const int n = tile + 2 * h;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long g = base + i;
    const bool in = g >= 0 && g < a.P;
    sv[0][i] = in ? load_col(a.x[c], a.type[c], g) : 0.0f;
    sf[0][i] = in ? a.start[g] : 1;
  }
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < a.reach; d *= 2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float s = sv[cur][i];
      const uint8_t b = sf[cur][i];
      const float ps = i >= d ? sv[cur][i - d] : 0.0f;
      const uint8_t pb = i >= d ? sf[cur][i - d] : 1;
      sv[cur ^ 1][i] = b ? s : addf(s, ps);
      sf[cur ^ 1][i] = b | pb;
    }
    cur ^= 1;
    __syncthreads();
  }
  float* hi = a.hi + (long long)c * a.P + a0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) hi[i] = sv[cur][h + i];
  if (c >= a.n_tot) return;  // the whole block leaves together

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long g = base + i;
    sf[cur][i] = (g >= 0 && g < a.P) ? a.end[g] : 0;
  }
  __syncthreads();
  for (int d = 1; d < a.reach; d *= 2) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint8_t k = sf[cur][i];
      const float nt = i + d < n ? sv[cur][i + d] : 0.0f;
      const uint8_t nk = i + d < n ? sf[cur][i + d] : 0;
      sv[cur ^ 1][i] = k ? sv[cur][i] : nt;
      sf[cur ^ 1][i] = k | nk;
    }
    cur ^= 1;
    __syncthreads();
  }
  float* tot = a.tot + (long long)c * a.P + a0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) tot[i] = sv[cur][h + i];
}

}  // namespace

// ptrs: the C columns, is_start, is_end, out ([C + n_tot, P]: hi, then tot);
// iparams: C, P, n_tot, reach, then the C column types
DSPMAP_API int dspmap_seg_scans(const uint64_t* p, const float*, const int* ip,
                                void* stream) {
  ScanArgs a = {};
  a.C = ip[0];
  a.P = ip[1];
  a.n_tot = ip[2];
  a.reach = ip[3];
  if (a.C < 1 || a.C > kMaxCols || a.P < 1 || a.n_tot < 0 || a.n_tot > a.C ||
      a.P > (1 << 30) || a.reach < 1 || a.reach > kMaxReach ||
      (a.reach & (a.reach - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < a.C; ++c) {
    a.x[c] = dptr<const void>(p, c);
    a.type[c] = ip[4 + c];
    if (a.type[c] < kF32 || a.type[c] > kI32) return (int)cudaErrorInvalidValue;
  }
  a.start = dptr<const uint8_t>(p, a.C);
  a.end = dptr<const uint8_t>(p, a.C + 1);
  a.hi = dptr<float>(p, a.C + 2);
  a.tot = a.hi + (long long)a.C * a.P;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.reach) {  // the form is chosen by reach alone
    case 16: launch_warp<4>(a, s); break;
    case 32: launch_warp<5>(a, s); break;
    default: {
      const dim3 grid((a.P + kTile - 1) / kTile, a.C);
      segscan_tile_kernel<<<grid, kTileThreads, 0, s>>>(a);
    }
  }
  return (int)cudaGetLastError();
}
