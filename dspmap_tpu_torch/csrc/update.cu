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
// Bound on the H100: the exponentials.  A pass is rows x S_t x CK pair terms
// (8.3M at the flagship, 29M at the multi-neighbor preset) against 0.5 to
// 30 MB of input.  Each term needs one ex2 on the special-function units
// (16 a clock an SM, against 128 float operations), so the card's least
// time for a pass is the pair count over 132 x 16 ex2 a clock, a little
// under its bytes over the memory rate at the multi-neighbor shape and above
// them at the others.
//
// Pass 1 (K3a): one block per pyramid row stages the row's S_t positions and
// weights and its CK points in shared memory; each thread owns one point m
// and loops over s in order.
//
// Pass 2 (K3b): one thread a particle would leave the card with 16 to 73
// thousand threads of 288 to 400 dependent terms each.  So the point axis is
// cut across lanes: a group of 16 lanes shares 4 particles of one row, lane
// j sums the points j, j + 16, .. in order (4 independent chains a lane,
// each point read from shared memory once for all 4), and the group's
// partial sums meet in a fixed xor-shuffle tree: no atomics, the same bits
// from run to run.  A block of 256 threads takes as many pyramid rows as
// give every group its particles (one at S_t = 64 and 32, four at S_t = 16)
// and stages their points once, laid out as (zx, zy, zz, c3 * cinv) a point:
// one 16-byte shared load a point.  A term is three subtractions, a
// multiply, two fused multiply-adds, the scale by -log2(e)/2, one
// ex2.approx and the accumulating multiply-add; its relative error (2^-22
// from ex2, 2^-23 from the scaled exponent) is far inside the bar of
// rtol 2e-5 against float64.  Measured and dropped (PERF.md section 6):
// 4, 8 and 32 lanes a particle, 1, 2 and 8 particles a lane, and staging
// the points as flat 16-byte words.
#include "common.cuh"

namespace {

constexpr float kC3 = 0.17958712212516656f;  // (1/sqrt(pi))^3

struct PairArgs {
  const float* pos;  // [R, S_t, 3] scaled
  const float* vec;  // w [R, S_t]
  const float* pts;  // [R, CK, 3] scaled
  float* out;        // [R, CK]
  int st, ck;
};

__device__ __forceinline__ float pair_g(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = subf(ax, bx), dy = subf(ay, by), dz = subf(az, bz);
  const float d2 = addf(addf(mulf(dx, dx), mulf(dy, dy)), mulf(dz, dz));
  return mulf(kC3, expf(mulf(-0.5f, d2)));
}

// shared layout: pos[st*3] | w[st] | pts[ck*3]
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

// ---------------------------------------------------------------- pass 2

constexpr int kPass2Threads = 256;
// g = c3 * exp(-d2 / 2) = c3 * 2^(-d2 * log2(e) / 2): one ex2 on the
// special-function unit
constexpr float kNegHalfLog2e = -0.72134752044448170368f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
      for (int t = 0; t < T; ++t) {
        const float dx = px[t] - z.x, dy = py[t] - z.y, dz = pz[t] - z.z;
        const float d2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        acc[t] = fmaf(ex2(kNegHalfLog2e * d2), z.w, acc[t]);
      }
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

int launch_pass1(const uint64_t* p, const int* ip, void* stream) {
  PairArgs a;
  a.pos = dptr<const float>(p, 0);
  a.vec = dptr<const float>(p, 1);
  a.pts = dptr<const float>(p, 2);
  a.out = dptr<float>(p, 3);
  const int rows = ip[0];
  a.st = ip[1];
  a.ck = ip[2];
  if (rows == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(a.st * 3 + a.st + a.ck * 3);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int threads = ((a.ck + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  pass1_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(a);
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
