// Euclidean clustering's label propagation over a bit-packed adjacency
// (plain version dspmap_tpu_torch/ops/cluster.py::euclidean_cluster_plain).
// It replaces no pallas_call: the JAX package runs the propagation as
// lax.while_loop sweeps over a boolean [n, n] adjacency
// (dspmap_tpu/ops/cluster.py::_propagate), which XLA compiles into the
// step's one program.  On the card the plain version wrote and re-read a
// [P, P] int32 matrix (100 MB at P = 5,000) in each of its sweeps; this
// kernel keeps the adjacency as bits and the labels in shared memory.
//
// What it computes: from the Gram product g = points @ points.T and
// sq = (points * points).sum(-1), both computed by PyTorch as the plain
// version computes them, the adjacency
//     adj[i, j] = ((sq[i] + sq[j]) - 2 * g[i, j] <= tol2) & valid[i] & valid[j]
// rounded as the plain version rounds it, then at most `iters` sweeps of
//     new[i] = min(L[i], min over adj[i, j] of L[j])
//     L[i]   = min(new[i], new[new[i]])       (new[P] = P, the sentinel)
// from L[i] = i on valid points and P on the others.  The output is L,
// with P on every invalid point.
//
// What bounds it on the H100: the Gram product (100 MB written by the
// library and read here once, some 0.06 ms at 3.35 TB/s for both); the
// adjacency is P * ceil(P / 32) words (3.1 MB at P = 5,000), which stays in
// the 50 MB L2 across the sweeps.  The sweeps themselves are latency-bound:
// each needs every row's `new` before any row's jump.  The design:
//
// * cluster_bits_kernel: a warp a valid row packs 32 columns a ballot into
//   a word of the row's bits; invalid rows and columns read no Gram entry
//   (the bits of an invalid row are never read).
// * cluster_propagate_kernel, one launch a sweep s: the jump of sweep
//   s - 1 is folded into the start of sweep s, so a sweep needs one barrier
//   (the launch boundary) instead of two.  Every block loads the previous
//   sweep's N_{s-1} into shared memory and rebuilds there
//   L_{s-1}[j] = min(N[j], N[N[j]]) for all j; then a warp a row takes the
//   minimum over the row's set bits and writes N_s[i] to the other of two
//   buffers.
// * cluster_labels_kernel: L = min(N, N[N]) of the last sweep run, and the
//   count of sweeps run added to a counter on the card.
//
// Early exit: sweep s - 1 changed no label exactly when no row's minimum
// changed in it (flags[s - 1] == 0) and no jump of its result changes a
// label; each block of launch s sees the second directly while it builds
// L_{s-1}.  The labels are then at their fixed point (a sweep of the fixed
// point gives it back), so flags[0] = s - 1 records where they stopped and
// the later launches return at once.  No launch runs more than `iters`
// sweeps, so the labels are the plain version's after exactly `iters`
// sweeps, converged or not.
//
// The host never waits: the stop is read on the card, so a captured graph
// holds the launches (2 + iters kernel nodes).
#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
// rows a warp takes in a sweep: blocks rebuild all P labels each, so fewer
// blocks rebuild less; two rows a warp still fill every SM at P = 5,000
constexpr int kRowsPerWarp = 2;
// words of a row a lane loads before it walks their bits
constexpr int kWordsInFlight = 8;
// Gram entries a lane loads before it packs them
constexpr int kEntriesInFlight = 8;
// a block's labels and the previous sweep's minima fill at most 227 KB of
// shared memory (8 bytes a point)
constexpr int kMaxP = 28672;
constexpr int kStaticSmem = 48 * 1024;

struct ClusterArgs {
  const float* gram;            // [P, P] f32
  const float* sq;              // [P] f32
  const unsigned char* valid;   // [P] bool
  unsigned* bits;               // [P, W]: bit b of word k of row i is adj[i, 32 k + b]
  int* next;                    // [2, P]: N_s at next + (s & 1) * P
  int* flags;                   // [iters + 1]: [0] the sweep whose labels
                                // repeat the one before (0: none yet);
                                // [s] whether sweep s changed a row's minimum
  int* labels;                  // [P] i32 out
  int* counter;                 // [2] i32: sweeps run, runs (summed over calls)
  float tol2;
  int P;
  int W;                        // ceil(P / 32)
  int iters;
};

__global__ void __launch_bounds__(kThreads) cluster_bits_kernel(ClusterArgs a) {
  const int lane = threadIdx.x % kWarp;
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t <= a.iters; t += blockDim.x) a.flags[t] = 0;
  for (int i = blockIdx.x * kWarps + threadIdx.x / kWarp; i < a.P;
       i += gridDim.x * kWarps) {
    if (!a.valid[i]) continue;  // warp-uniform
    const float sq_i = a.sq[i];
    const float* __restrict__ g = a.gram + (size_t)i * a.P;
    unsigned* row = a.bits + (size_t)i * a.W;
    for (int k0 = 0; k0 < a.W; k0 += kWarp) {
      unsigned mine = 0u;  // word k0 + lane of the row
      for (int k1 = k0; k1 < k0 + kWarp && k1 < a.W; k1 += kEntriesInFlight) {
        float gv[kEntriesInFlight];
        bool ok[kEntriesInFlight];
#pragma unroll
        for (int u = 0; u < kEntriesInFlight; ++u) {
          const int j = (k1 + u) * kWarp + lane;
          ok[u] = k1 + u < a.W && j < a.P && a.valid[j];
          gv[u] = ok[u] ? __ldg(g + j) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kEntriesInFlight; ++u) {
          const int j = (k1 + u) * kWarp + lane;
          // (sq[i] + sq[j]) - 2 g, each rounded as PyTorch rounds it; the
          // doubling is exact, so no contraction could change a bit
          const float d2 = ok[u] ? subf(addf(sq_i, a.sq[j]), mulf(2.0f, gv[u]))
                                 : 0.0f;
          const unsigned word = __ballot_sync(kFull, ok[u] && d2 <= a.tol2);
          if (lane == k1 + u - k0) mine = word;
        }
      }
      if (k0 + lane < a.W) row[k0 + lane] = mine;
    }
  }
}

__global__ void __launch_bounds__(kThreads) cluster_propagate_kernel(
    ClusterArgs a, int s) {
  extern __shared__ int smem[];
  int* lab = smem;          // [P]: L_{s-1}
  int* prev = smem + a.P;   // [P]: N_{s-1}
  if (__syncthreads_or(threadIdx.x == 0 && a.flags[0] != 0)) return;
  const int P = a.P;
  bool jumped = false;
  if (s == 1) {
    for (int j = threadIdx.x; j < P; j += blockDim.x)
      lab[j] = a.valid[j] ? j : P;
  } else {
    // N_{s-1} into shared memory in one pass of loads, then the jump
    // from there, into the other array
    const int* __restrict__ n = a.next + ((s - 1) & 1) * P;
#pragma unroll 4
    for (int j = threadIdx.x; j < P; j += blockDim.x) prev[j] = __ldg(n + j);
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      const int v = prev[j];
      const int m = v < P ? prev[v] : P;
      jumped |= m < v;
      lab[j] = min(v, m);
    }
  }
  if (!__syncthreads_or(jumped) && s > 1 && a.flags[s - 1] == 0) {
    // sweep s - 1 gave back the labels it was given: they are final
    if (threadIdx.x == 0) a.flags[0] = s - 1;
    return;
  }
  const int lane = threadIdx.x % kWarp;
  int* cur = a.next + (s & 1) * P;  // N_s
  bool changed = false;
  for (int i = blockIdx.x * kWarps + threadIdx.x / kWarp; i < P;
       i += gridDim.x * kWarps) {
    const int own = lab[i];
    int m = own;
    if (a.valid[i]) {  // warp-uniform; an invalid row keeps the sentinel
      const unsigned* __restrict__ row = a.bits + (size_t)i * a.W;
      for (int k0 = 0; k0 < a.W; k0 += kWarp * kWordsInFlight) {
        unsigned w[kWordsInFlight];
#pragma unroll
        for (int u = 0; u < kWordsInFlight; ++u) {
          const int k = k0 + u * kWarp + lane;
          w[u] = k < a.W ? __ldg(row + k) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kWordsInFlight; ++u) {
          const int* col = lab + (k0 + u * kWarp + lane) * kWarp;
          for (unsigned x = w[u]; x; x &= x - 1) m = min(m, col[__ffs(x) - 1]);
        }
      }
      m = __reduce_min_sync(kFull, m);
    }
    if (lane == 0) cur[i] = m;
    changed |= m != own;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) a.flags[s] = 1;
}

__global__ void __launch_bounds__(kThreads) cluster_labels_kernel(
    ClusterArgs a) {
  const int P = a.P;
  const int stop = a.flags[0];
  const int s = stop ? stop : a.iters;  // the sweeps run
  const int* __restrict__ n = a.next + (s & 1) * P;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < P;
       j += gridDim.x * blockDim.x) {
    int l = P;
    if (a.valid[j]) {
      if (s == 0) {
        l = j;
      } else {
        const int v = n[j];
        l = min(v, v < P ? n[v] : P);
      }
    }
    a.labels[j] = l;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(a.counter, s);
    atomicAdd(a.counter + 1, 1);
  }
}

}  // namespace

DSPMAP_API int dspmap_euclidean_cluster(const uint64_t* p, const float* f,
                                        const int* ip, void* stream) {
  ClusterArgs a;
  a.gram = dptr<const float>(p, 0);
  a.sq = dptr<const float>(p, 1);
  a.valid = dptr<const unsigned char>(p, 2);
  a.bits = dptr<unsigned>(p, 3);
  a.next = dptr<int>(p, 4);
  a.flags = dptr<int>(p, 5);
  a.labels = dptr<int>(p, 6);
  a.counter = dptr<int>(p, 7);
  a.tol2 = f[0];
  a.P = ip[0];
  a.iters = ip[1];
  if (a.P < 1 || a.P > kMaxP || a.iters < 0) return (int)cudaErrorInvalidValue;
  a.W = (a.P + kWarp - 1) / kWarp;
  const cudaStream_t st = (cudaStream_t)stream;

  const int smem = 2 * a.P * (int)sizeof(int);
  // shared memory above 48 KB is dynamic shared memory the kernel must be
  // granted
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > kStaticSmem && smem > granted[dev]) {
    e = cudaFuncSetAttribute(cluster_propagate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }

  const unsigned row_blocks = (unsigned)((a.P + kWarps - 1) / kWarps);
  cluster_bits_kernel<<<row_blocks, kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = kWarps * kRowsPerWarp;
  const unsigned sweep_blocks = (unsigned)((a.P + rows - 1) / rows);
  for (int s = 1; s <= a.iters; ++s) {
    cluster_propagate_kernel<<<sweep_blocks, kThreads, smem, st>>>(a, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned label_blocks = (unsigned)((a.P + kThreads - 1) / kThreads);
  cluster_labels_kernel<<<label_blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
