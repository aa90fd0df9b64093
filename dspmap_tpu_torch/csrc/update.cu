// Measurement-update pair passes (replace
// dspmap_tpu/ops/pallas/update.py::update_pass1 and ::update_pass2; spec:
// the dense x dense blocks of dspmap_tpu/ops/update.py::measurement_update).
//
//   pass 1: out[r, m] = sum_s w[r, s] * c3 * exp(-|x_s - z_m|^2 / 2)
//   pass 2: out[r, s] = sum_m c3 * exp(-|x_s - z_m|^2 / 2) * cinv[r, m]
//
// with c3 = pi^-3/2 and coordinates pre-scaled by 1/sigma by the wrapper.
//
// Bound on the H100: the exponentials.  A flagship pass is 448 x 64 x 288
// = 8.3M pair terms -- one expf and ~10 other float operations each --
// against ~0.5 MB of input, so it is compute (SFU) bound and tiny either
// way.  Design: one block per pyramid row stages the row's S_t positions
// and weights and its CK points (~4.6 KB) in shared memory; in pass 1 each
// thread owns one point m and loops over s in order, in pass 2 each thread
// owns one particle s and loops over m in order, so neither pass needs a
// cross-thread reduction.  d2 is formed from coordinate differences (as in
// the Pallas kernel), which avoids the |a|^2 + |b|^2 - 2ab cancellation of
// the matmul form at world coordinates of several metres over sigma.
#include "common.cuh"

namespace {

constexpr float kC3 = 0.17958712212516656f;  // (1/sqrt(pi))^3

struct PairArgs {
  const float* pos;  // [R, S_t, 3] scaled
  const float* vec;  // pass 1: w [R, S_t]; pass 2: cinv [R, CK]
  const float* pts;  // [R, CK, 3] scaled
  float* out;        // pass 1: [R, CK]; pass 2: [R, S_t]
  int st, ck;
};

__device__ __forceinline__ float pair_g(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = subf(ax, bx), dy = subf(ay, by), dz = subf(az, bz);
  const float d2 = addf(addf(mulf(dx, dx), mulf(dy, dy)), mulf(dz, dz));
  return mulf(kC3, expf(mulf(-0.5f, d2)));
}

// shared layout: pos[st*3] | w-or-cinv[st or ck] | pts[ck*3]
__global__ void pass1_kernel(PairArgs a) {
  extern __shared__ float sm[];
  const int r = blockIdx.x;
  float* spos = sm;
  float* sw = spos + a.st * 3;
  float* spts = sw + a.st;
  for (int i = threadIdx.x; i < a.st * 3; i += blockDim.x)
    spos[i] = a.pos[(long long)r * a.st * 3 + i];
  for (int i = threadIdx.x; i < a.st; i += blockDim.x)
    sw[i] = a.vec[(long long)r * a.st + i];
  for (int i = threadIdx.x; i < a.ck * 3; i += blockDim.x)
    spts[i] = a.pts[(long long)r * a.ck * 3 + i];
  __syncthreads();
  for (int m = threadIdx.x; m < a.ck; m += blockDim.x) {
    const float zx = spts[m * 3], zy = spts[m * 3 + 1], zz = spts[m * 3 + 2];
    float acc = 0.0f;
    for (int s = 0; s < a.st; ++s) {
      const float g = pair_g(spos[s * 3], spos[s * 3 + 1], spos[s * 3 + 2],
                             zx, zy, zz);
      acc = addf(acc, mulf(sw[s], g));
    }
    a.out[(long long)r * a.ck + m] = acc;
  }
}

__global__ void pass2_kernel(PairArgs a) {
  extern __shared__ float sm[];
  const int r = blockIdx.x;
  float* spos = sm;
  float* sc = spos + a.st * 3;
  float* spts = sc + a.ck;
  for (int i = threadIdx.x; i < a.st * 3; i += blockDim.x)
    spos[i] = a.pos[(long long)r * a.st * 3 + i];
  for (int i = threadIdx.x; i < a.ck; i += blockDim.x)
    sc[i] = a.vec[(long long)r * a.ck + i];
  for (int i = threadIdx.x; i < a.ck * 3; i += blockDim.x)
    spts[i] = a.pts[(long long)r * a.ck * 3 + i];
  __syncthreads();
  for (int s = threadIdx.x; s < a.st; s += blockDim.x) {
    const float x = spos[s * 3], y = spos[s * 3 + 1], z = spos[s * 3 + 2];
    float acc = 0.0f;
    for (int m = 0; m < a.ck; ++m) {
      const float g = pair_g(x, y, z, spts[m * 3], spts[m * 3 + 1],
                             spts[m * 3 + 2]);
      acc = addf(acc, mulf(g, sc[m]));
    }
    a.out[(long long)r * a.st + s] = acc;
  }
}

int round_up32(int x) { return ((x + 31) / 32) * 32; }

int launch_pair(bool pass1, const uint64_t* p, const int* ip, void* stream) {
  PairArgs a;
  a.pos = dptr<const float>(p, 0);
  a.vec = dptr<const float>(p, 1);
  a.pts = dptr<const float>(p, 2);
  a.out = dptr<float>(p, 3);
  const int rows = ip[0];
  a.st = ip[1];
  a.ck = ip[2];
  if (rows == 0) return 0;
  const int vec_len = pass1 ? a.st : a.ck;
  const size_t smem = sizeof(float) * (size_t)(a.st * 3 + vec_len + a.ck * 3);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int threads = round_up32(pass1 ? a.ck : a.st);
  if (threads > 1024) threads = 1024;
  if (pass1)
    pass1_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(a);
  else
    pass2_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: pos vec pts out;  iparams: rows S_t CK
DSPMAP_API int dspmap_update_pass1(const uint64_t* p, const float*, const int* ip,
                                   void* stream) {
  return launch_pair(true, p, ip, stream);
}

DSPMAP_API int dspmap_update_pass2(const uint64_t* p, const float*, const int* ip,
                                   void* stream) {
  return launch_pair(false, p, ip, stream);
}
