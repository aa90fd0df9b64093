// Relayout copies between pool planes [S, V] and their flat working form
// (replace dspmap_tpu/ops/pallas/relayout.py::to_flat and ::from_flat; plain
// versions dspmap_tpu_torch/ops/relayout.py::to_flat_many_plain /
// from_flat_many_plain).
//
// What the TPU kernels compute is an exact copy of S*V 4-byte words between
// the tiled plane and the flat array; their row groups of 8, VMEM staging
// and per-row DMAs answer Mosaic's tiling rules and are not carried over.
// On this card a contiguous [S, V] tensor is already row-major, so both
// directions are the same word-for-word copy.  What the copy buys here:
// to_flat fills working buffers of S*V + 1 words that the step owns (the
// last word is the drop sentinel of the pool scatters), so every scatter
// between the sweep and the occupancy stage writes in place instead of
// copying the whole plane first; from_flat hands the returned state a fresh
// plane of the exact size for a flat plane that the occupancy kernel passes
// through.
//
// Bound on the H100: memory.  4*S*V bytes a plane are read and as many
// written, nothing is computed, and one plane's copy (11 us of device time)
// is short beside the launch around it.  Design: one launch copies all the
// planes of a frame.  The by-value argument holds a table of up to kMaxCopies
// (source, destination) pairs; blockIdx.y picks the pair, blockIdx.x walks
// the plane.  The kernel is typed by word size only, so f32 and i32 planes
// share a launch; V % 1024 == 0 makes the word count a multiple of 4 and the
// wrapper checks that every base pointer is 16-byte aligned.
//
// The device loop is a grid-stride loop over 16-byte words, four independent
// loads in flight a thread, neighbouring threads on neighbouring words.  (A
// ring of 1-D bulk copies through shared memory, cp.async.bulk completing on
// an mbarrier, measured 4-7% slower on the same seven planes: PERF.md
// section 6.)
#include "common.cuh"

namespace {

constexpr int kMaxCopies = 9;

struct CopyArgs {
  const uint4* src[kMaxCopies];
  uint4* dst[kMaxCopies];
  long long n16;  // 16-byte words a plane
};

// the pair of plane blockIdx.y (a select chain: the table stays in the
// kernel's parameter space)
__device__ __forceinline__ void pick_pair(const CopyArgs& a, const uint4*& src,
                                          uint4*& dst) {
  src = a.src[0];
  dst = a.dst[0];
#pragma unroll
  for (int k = 1; k < kMaxCopies; ++k)
    if (blockIdx.y == k) src = a.src[k], dst = a.dst[k];
}

__global__ void __launch_bounds__(256) copy16_kernel(CopyArgs a) {
  const uint4* from;
  uint4* to;
  pick_pair(a, from, to);
  const uint4* __restrict__ src = from;
  uint4* __restrict__ dst = to;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < a.n16; i += 4 * stride) {
    const uint4 x0 = src[i], x1 = src[i + stride], x2 = src[i + 2 * stride],
                x3 = src[i + 3 * stride];
    dst[i] = x0;
    dst[i + stride] = x1;
    dst[i + 2 * stride] = x2;
    dst[i + 3 * stride] = x3;
  }
  for (; i < a.n16; i += stride) dst[i] = src[i];
}

// ptrs: src0 dst0 src1 dst1 ...;  iparams: S V n
// (4-byte words a plane = S*V, n planes)
int launch_copies(const uint64_t* p, const int* ip, void* stream) {
  const long long words = (long long)ip[0] * (long long)ip[1];
  const int n = ip[2];
  if (words == 0 || n == 0) return 0;
  if (n < 0 || n > kMaxCopies) return (int)cudaErrorInvalidValue;
  CopyArgs a = {};
  for (int k = 0; k < n; ++k) {
    if (words % 4 != 0 || (p[2 * k] | p[2 * k + 1]) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    a.src[k] = dptr<const uint4>(p, 2 * k);
    a.dst[k] = dptr<uint4>(p, 2 * k + 1);
  }
  a.n16 = words / 4;
  const int threads = 256;
  long long blocks = (a.n16 + threads - 1) / threads;
  // a few waves of blocks over the card in all, shared among the planes
  const long long cap = (132LL * 16 + n - 1) / n;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, n);
  copy16_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// planes [S, V] -> the first S*V words of their flat working buffers
DSPMAP_API int dspmap_to_flat(const uint64_t* p, const float*, const int* ip,
                              void* stream) {
  return launch_copies(p, ip, stream);
}

// flat planes [S*V] -> fresh planes [S, V]
DSPMAP_API int dspmap_from_flat(const uint64_t* p, const float*, const int* ip,
                                void* stream) {
  return launch_copies(p, ip, stream);
}
