// Jonker-Volgenant shortest augmenting paths, one launch a solve (replaces
// the lax.while_loops of dspmap_tpu/ops/assignment.py::solve_assignment,
// :118-205; no pallas_call: XLA compiles those loops into the step's one
// program; plain version dspmap_tpu_torch/ops/assignment.py::_jv_plain).
//
// What it computes: for the square cost a [N, N] (solve_assignment's
// squared-up matrix), rows 1 .. min(n_rows, R) are augmented in order, each
// by one shortest augmenting path over the columns with the dual potentials
// u (by row) and v (by column), in the cumulative-delta form of the JAX
// package.  The output p [N+1] holds the (1-based) row owning each column;
// p[0] is the last row augmented, as in the plain version.
//
// What bounds it on the H100: neither bytes (4*N*N of cost) nor operations
// (about 5*N a path step, at most N*(N+1)/2 path steps) -- both lie far under
// the cost of a launch.  The time is the chain of dependent path steps: each
// relaxes every column, then takes the argmin over the columns, which the
// next step depends on.  So the design shortens each step's latency; two
// arms, chosen by N in the C entry:
//
// * the warp arm (N + 1 <= 32; every preset has N = max_clusters = 16): one
//   warp, lane = column, lane 0 the virtual column 0.  The cost is staged
//   once in shared memory, a row padded to 32 with u[r] in its column 0, so
//   a step reads its cost row and u[i0] from shared memory and nothing from
//   device memory; the masked value (m_abs, 1e12 once used) and its key,
//   way, used, d_use, v and p[c] stay in registers.  The argmin keys each
//   lane's value so that unsigned order is torch.argmin's and takes two
//   hardware warp minima (redux.sync): the least key, then, over the lanes
//   holding it, (column, owner) packed, so the next row to read comes with
//   the column; the value comes by shuffle, off that chain.  No block
//   barrier: __syncwarp only where shared memory is written and then read.
//   The unwind walks `way` by one shuffle a step, every lane together.
// * the block arm (32 <= N <= 1023): one block, a thread a column, a
//   butterfly in each warp, then a pass over the warps' minima in shared
//   memory, two block barriers a step; thread 0 unwinds the path.
//
// n_rows is read on the card, so the host never waits and a captured graph
// holds the launch.
//
// Bits: every float operation is an add, subtract or compare, rounded as the
// plain version rounds them (cand = ((a - u[i0]) - v) + d_now), and the
// argmin keeps the lowest column among equal minima (NaN first, -0.0 equal
// to +0.0), as torch.argmin does.  The potentials change on used columns
// only; the plain version's +0.0 on the others changes no bit, since u never
// holds -0.0.
#include "common.cuh"

namespace {

constexpr int kMaxN = 1023;  // one thread a column plus the virtual column
constexpr int kThreads = kMaxN + 1;
constexpr int kWarp = 32;
constexpr int kWarpMaxN = kWarp - 1;  // the warp arm's largest N
constexpr int kPresetN = 16;          // every preset's N = max_clusters
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1.0e12f;  // INF of the plain version

struct JvArgs {
  const float* a;            // [N, N] f32
  const long long* n_rows;   // 0-d: rows to augment (1-based count)
  long long* p_out;          // [N+1] i64
  int N;
  int R;
};

// The argmin's key: its unsigned order is torch.argmin's order of the
// values -- NaN below every number, -0.0 equal to +0.0 -- so the lowest lane
// holding the least key is the argmin.
__device__ __forceinline__ unsigned argmin_key(float x) {
  if (x != x) return 0u;
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? 0u - b : (b | 0x80000000u);  // -0.0 as +0.0
}

// kRows: a bound on N, kPresetN or kWarpMaxN
template <int kRows>
__global__ void __launch_bounds__(kWarp) jv_warp_kernel(JvArgs args) {
  // a_s[r * 32 + c] = a[r - 1, c - 1] for 1 <= r, c <= N: lane c reads cost
  // row r at r * 32 + c; a_s[r * 32] holds u[r], read by every lane beside
  // its cost (row 0 and what lies past N are never used)
  __shared__ float a_s[kWarp * kWarp];

  const int N = args.N;
  const int c = threadIdx.x;  // column, 0 the virtual one
  const bool real = c >= 1 && c <= N;
  const float* __restrict__ a = args.a;

  // every load is issued before the first lands: one round trip to device
  // memory for n_rows and the cost together, none inside the path chain;
  // the loops run to kRows, a bound on N, since a lone warp pays for every
  // instruction it issues, predicated off or not
  const long long nr = *args.n_rows;
  float cost[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    cost[r] = real && r < N ? __ldg(a + (r * N + c - 1)) : 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) a_s[(r + 1) * kWarp + c] = cost[r];
  const int rows = (int)(nr < (long long)args.R ? nr : (long long)args.R);
  // the key a lane holds once its column is used (1e12's), or always where
  // it is no column (+inf's: above every column's)
  const unsigned closed =
      argmin_key(real ? kInf : __int_as_float(0x7f800000));
  int p = 0;       // p[c]: the row owning column c; lane 0 the row augmented
  float v = 0.0f;  // v[c]
  __syncwarp();

  for (int i = 1; i <= rows; ++i) {
    if (c == 0) p = i;
    // mval: the plain version's masked value of this column (m_abs while
    // the column is open, 1e12 once used), kval its key
    float mval = kInf, d_use = 0.0f, d_now = 0.0f;
    unsigned kval = real ? argmin_key(kInf) : closed;
    int way = 0, j0 = 0, at = i * kWarp;  // at: where row i0 = p[j0] starts
    bool open = real, used = false;
    for (int step = 0; step < i; ++step) {
      if (c == j0) {
        used = true;
        open = false;
        d_use = d_now;
        mval = kInf;
        kval = closed;
      }
      const float ui0 = a_s[at];
      const float cand = addf(subf(subf(a_s[at + c], ui0), v), d_now);
      if (open && cand < mval) {
        mval = cand;
        kval = argmin_key(cand);
        way = j0;
      }
      // the argmin: the least key, then the lowest lane holding it, whose
      // column and owner come packed in a second warp minimum
      const unsigned least = __reduce_min_sync(kFull, kval);
      const unsigned pick = __reduce_min_sync(
          kFull, kval == least ? (unsigned)(c << 10 | p << 5) : ~0u);
      j0 = (int)(pick >> 10);
      at = (int)(pick & 0x3e0u);
      d_now = __shfl_sync(kFull, mval, j0);
      if (at == 0) break;  // a free column ends the path (warp-uniform)
    }
    // the dual potentials, on used columns only: their owners are distinct
    // rows, and every lane's reads of u lie before the last warp minimum
    if (used) {
      const float amt = subf(d_now, d_use);
      a_s[p * kWarp] = addf(a_s[p * kWarp], amt);
      v = subf(v, amt);
    }
    // the unwind, p[j] = p[way[j]] along the path from j0: no column comes
    // twice (way leads to columns used earlier), so each reads p as it was
    // before the unwind -- one shuffle for every lane, then the walk marks
    // the path's columns
    const int p_way = __shfl_sync(kFull, p, way);
    bool on_path = false;
    for (int step = 0, j = j0; step < i && j != 0; ++step) {
      on_path |= c == j;
      j = __shfl_sync(kFull, way, j);
    }
    if (on_path) p = p_way;
    __syncwarp();  // u written above is read by the next row
  }
  if (c <= N) args.p_out[c] = (long long)p;
}

// (value, column) order of torch.argmin: NaN before any number, then the
// smaller value, then the lower column
__device__ __forceinline__ bool before(float x, int i, float y, int k) {
  const bool xn = x != x, yn = y != y;
  if (xn || yn) return xn && (!yn || i < k);
  return x < y || (x == y && i < k);
}

__global__ void __launch_bounds__(kThreads) jv_kernel(JvArgs args) {
  __shared__ float u_s[kThreads];
  __shared__ int p_s[kThreads];
  __shared__ int way_s[kThreads];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  const int N = args.N;
  const int c = threadIdx.x;          // column, 0 the virtual one
  const bool real = c >= 1 && c <= N;
  const int lane = c & 31, warp = c >> 5, n_warps = (blockDim.x + 31) >> 5;
  const float* __restrict__ a = args.a;

  if (c <= N) {
    u_s[c] = 0.0f;
    p_s[c] = 0;
  }
  float v = 0.0f;
  long long nr = *args.n_rows;
  const int rows = (int)(nr < (long long)args.R ? nr : (long long)args.R);
  __syncthreads();

  for (int i = 1; i <= rows; ++i) {
    if (c == 0) p_s[0] = i;
    float m_abs = kInf, d_use = 0.0f;
    int way = 0;
    bool used = false;
    int j0 = 0;
    float d_now = 0.0f;
    bool done = false;
    __syncthreads();
    for (int step = 0; step < i && !done; ++step) {
      if (c == j0) {
        used = true;
        d_use = d_now;
      }
      const int i0 = p_s[j0];
      const float ui0 = u_s[i0];
      float masked = __int_as_float(0x7f800000);  // +inf: not a column
      if (real) {
        const float cand = addf(
            subf(subf(__ldg(a + (size_t)(i0 - 1) * N + (c - 1)), ui0), v),
            d_now);
        if (!used && cand < m_abs) {
          m_abs = cand;
          way = j0;
        }
        masked = used ? kInf : m_abs;
      }
      // argmin over the columns: a butterfly in each warp, then every
      // thread passes over the warps' minima in order
      float bv = masked;
      int bi = c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      bv = red_v[0];
      bi = red_i[0];
      for (int w = 1; w < n_warps; ++w)
        if (before(red_v[w], red_i[w], bv, bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      done = p_s[bi] == 0;
      j0 = bi;
      d_now = bv;
      __syncthreads();  // red_* are rewritten by the next step
    }
    // the dual potentials, on used columns only (their owners are distinct
    // rows), then the unwind of the augmenting path by one thread
    if (used) {
      const float amt = subf(d_now, d_use);
      u_s[p_s[c]] = addf(u_s[p_s[c]], amt);
      v = subf(v, amt);
    }
    if (c <= N) way_s[c] = real ? way : 0;
    __syncthreads();
    if (c == 0) {
      int j = j0;
      for (int step = 0; step < i && j != 0; ++step) {
        const int j1 = way_s[j];
        p_s[j] = p_s[j1];
        j = j1;
      }
    }
    __syncthreads();
  }
  if (c <= N) args.p_out[c] = (long long)p_s[c];
}

}  // namespace

// ptrs: a, n_rows, p_out;  iparams: N R
DSPMAP_API int dspmap_jv_solve(const uint64_t* p, const float*, const int* ip,
                               void* stream) {
  JvArgs args;
  args.a = dptr<const float>(p, 0);
  args.n_rows = dptr<const long long>(p, 1);
  args.p_out = dptr<long long>(p, 2);
  args.N = ip[0];
  args.R = ip[1];
  if (args.N < 1 || args.N > kMaxN || args.R < 0 || args.R > args.N)
    return (int)cudaErrorInvalidValue;
  if (args.N <= kPresetN) {
    jv_warp_kernel<kPresetN><<<1, kWarp, 0, (cudaStream_t)stream>>>(args);
  } else if (args.N <= kWarpMaxN) {
    jv_warp_kernel<kWarpMaxN><<<1, kWarp, 0, (cudaStream_t)stream>>>(args);
  } else {
    const int threads = (args.N + 1 + 31) / 32 * 32;
    jv_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}
