// Relayout copies between a pool plane [S, V] and its flat working form
// (replace dspmap_tpu/ops/pallas/relayout.py::to_flat and ::from_flat; plain
// versions dspmap_tpu_torch/ops/relayout.py::to_flat_plain / from_flat_plain).
//
// What the TPU kernels compute is an exact copy of S*V 4-byte words between
// the tiled plane and the flat array; their row groups of 8, VMEM staging
// and per-row DMAs answer Mosaic's tiling rules and are not carried over.
// On this card a contiguous [S, V] tensor is already row-major, so both
// directions are the same word-for-word copy.  What the copy buys here:
// to_flat fills a working buffer of S*V + 1 words that the step owns (the
// last word is the drop sentinel of the pool scatters), so every scatter
// between the sweep and the occupancy stage writes in place instead of
// copying the whole plane first; from_flat hands the occupancy kernel and
// the returned state a fresh plane of the exact size.
//
// Bound on the H100: memory.  4*S*V bytes are read and as many written,
// nothing is computed.  Design: a grid-stride loop over 16-byte words
// (uint4), neighbouring threads on neighbouring words; V % 1024 == 0 makes
// the word count a multiple of 4 and the wrapper checks that both base
// pointers are 16-byte aligned.  The kernel is typed by word size only, so
// f32 and i32 planes share it.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) copy16_kernel(const uint4* __restrict__ src,
                                                     uint4* __restrict__ dst,
                                                     long long n16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    dst[i] = src[i];
}

// ptrs: src dst;  iparams: S V (4-byte words per plane = S*V)
int launch_copy(const uint64_t* p, const int* ip, void* stream) {
  const long long words = (long long)ip[0] * (long long)ip[1];
  if (words == 0) return 0;
  if (words % 4 != 0 || (p[0] | p[1]) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n16 = words / 4;
  const int threads = 256;
  long long blocks = (n16 + threads - 1) / threads;
  const long long cap = 132LL * 16;  // a few waves per SM, then stride
  if (blocks > cap) blocks = cap;
  copy16_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      dptr<const uint4>(p, 0), dptr<uint4>(p, 1), n16);
  return (int)cudaGetLastError();
}

}  // namespace

// plane [S, V] -> the first S*V words of the flat working buffer
DSPMAP_API int dspmap_to_flat(const uint64_t* p, const float*, const int* ip,
                              void* stream) {
  return launch_copy(p, ip, stream);
}

// flat [S*V] -> a fresh plane [S, V]
DSPMAP_API int dspmap_from_flat(const uint64_t* p, const float*, const int* ip,
                                void* stream) {
  return launch_copy(p, ip, stream);
}
