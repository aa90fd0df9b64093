// Segmented-scan pair of the compact layout (replaces
// dspmap_tpu/ops/pallas/segscan.py::seg_scans_pallas; spec:
// dspmap_tpu_torch/ops/compact.py::seg_cumsum_plain and fill_from_end_plain).
//
// Per column c of x [C, P]:
//   hi[c]  = segmented inclusive prefix sum, runs starting at is_start:
//            for d = 1, 2, .. < reach:  s = b ? s : s + s[i-d];  b |= b[i-d]
//            (fill (0, true) before row 0);
//   tot[c] (c < n_tot) = each run's value at its end row, filled backward:
//            for d = 1, 2, .. < reach:  t = k ? t : t[i+d];  k |= k[i+d]
//            starting from t = hi[c], k = is_end (fill (0, false) past row P-1).
// The steps run in the same order with the same float adds as the plain
// version, so hi and tot are bit-equal to it.  Any other association (a
// warp-shuffle or decoupled-lookback scan) moves the run sums by an ulp and
// the resample's ceil(x/wa - 1/2) boundaries with them.
//
// Bound on the H100: launches.  The largest call of a frame moves about
// 8 MB (7 columns x 131072 rows in and out), under 3 us at 3.35 TB/s.
// Design: one block per (tile of kTile rows, column).  A row's hi depends on
// the reach-1 rows before it and its tot on the reach-1 rows after it, so a
// block stages rows [a - (reach-1), b + (reach-1)) of its tile [a, b) in
// shared memory (rows outside [0, P) as the recurrence's own fill values),
// runs the forward steps and then the backward steps over the whole buffer,
// each step double-buffered and separated by __syncthreads, and writes
// [a, b) only: every row it writes depends only on rows it holds exactly.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kMaxReach = 512;
constexpr int kBuf = kTile + 2 * (kMaxReach - 1);
constexpr int kThreads = 256;

struct ScanArgs {
  const float* x;         // [C, P]
  const uint8_t* start;   // [P] run starts
  const uint8_t* end;     // [P] run ends (live rows only)
  float* hi;              // [C, P]
  float* tot;             // [max(n_tot, 1), P]
  int P, n_tot, reach;
};

__global__ void segscan_kernel(ScanArgs a) {
  __shared__ float sv[2][kBuf];
  __shared__ uint8_t sf[2][kBuf];
  const int c = blockIdx.y;
  const int h = a.reach - 1;
  const long long a0 = (long long)blockIdx.x * kTile;
  const int tile = (int)min((long long)kTile, a.P - a0);
  const long long base = a0 - h;  // global row of buffer slot 0
  const int n = tile + 2 * h;
  const float* x = a.x + (long long)c * a.P;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long g = base + i;
    const bool in = g >= 0 && g < a.P;
    sv[0][i] = in ? x[g] : 0.0f;
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

// ptrs: x, is_start, is_end, hi, tot; ip: C, P, n_tot, reach
DSPMAP_API int dspmap_seg_scans(const uint64_t* p, const float*, const int* ip,
                                void* stream) {
  ScanArgs a;
  a.x = dptr<const float>(p, 0);
  a.start = dptr<const uint8_t>(p, 1);
  a.end = dptr<const uint8_t>(p, 2);
  a.hi = dptr<float>(p, 3);
  a.tot = dptr<float>(p, 4);
  const int C = ip[0];
  a.P = ip[1];
  a.n_tot = ip[2];
  a.reach = ip[3];
  if (C < 1 || a.P < 1 || a.n_tot < 0 || a.n_tot > C || a.reach < 1 ||
      a.reach > kMaxReach)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.P + kTile - 1) / kTile, C);
  segscan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
