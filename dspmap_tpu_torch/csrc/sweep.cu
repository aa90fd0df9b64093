// Fused per-slot sweep (replaces dspmap_tpu/ops/pallas/sweep.py::sweep_pallas;
// spec: dspmap_tpu_torch/ops/sweep.py::sweep_reference).  `cell_base` is the
// global storage cell of column 0: 0 on the whole pool, the slab's first cell
// on a slab of the sharded step, where a slot is a mover when its new cell
// differs from cell_base + column (new_cell stays global).
//
// Per [S, V] slot: constant-velocity advance, world voxel, window test and
// moved-out kill, toroidal storage cell, mover mask, rotation into the sensor
// frame, atan2 azimuth/elevation and pyramid index, packed into `tags`.
//
// Bound on the H100: memory.  Each slot reads 6 words and writes 5
// (~44 B/slot, ~140 MB per flagship sweep); the arithmetic (two atan2f) is
// far below the card's float rate.  Design: one thread per slot over the
// flat [S*V] planes, so neighbouring threads touch neighbouring addresses
// and every load and store is coalesced; the frame's scalars ride in a
// by-value struct.  vz is not read: under limit_motion_to_xy_plane (the
// only configurations that take the fused sweep with a nonzero velocity)
// vz is identically zero, so pz does not advance and the moving test
// reduces to vx/vy -- as in the Pallas kernel.
#include "common.cuh"

namespace {

struct SweepArgs {
  const int* flags;
  const float *px, *py, *pz, *vx, *vy;
  float *opx, *opy;
  int *oflags, *ocell, *otags;
  long long n;  // S * V
  int V;
  float dt, sx0, sy0, sz0, inv_res, half_h, half_v, res;
  float R[9];
  int ox, oy, oz, sox, soy, soz, nx, ny, nz, nph, npv, advance;
  int cell_base;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void sweep_kernel(SweepArgs a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int col = (int)(i % a.V);
  const int flags = a.flags[i];
  const bool valid = flags != 0;
  float px = a.px[i], py = a.py[i];
  const float pz = a.pz[i];
  const float vx = a.vx[i], vy = a.vy[i];
  if (a.advance && valid) {
    px = addf(px, mulf(vx, a.dt));
    py = addf(py, mulf(vy, a.dt));
  }
  const int wx = (int)floorf(mulf(px, a.inv_res));
  const int wy = (int)floorf(mulf(py, a.inv_res));
  const int wz = (int)floorf(mulf(pz, a.inv_res));
  const int rx = wx - a.ox, ry = wy - a.oy, rz = wz - a.oz;
  const bool inside = rx >= 0 && rx < a.nx && ry >= 0 && ry < a.ny &&
                      rz >= 0 && rz < a.nz;
  const bool moved_out = valid && !inside;

  // floor-mod storage cell: mod(origin, dims) is precomputed on the host
  // and folded back by one conditional subtract (C's % truncates)
  int cx = a.sox + clampi(rx, 0, a.nx - 1);
  int cy = a.soy + clampi(ry, 0, a.ny - 1);
  int cz = a.soz + clampi(rz, 0, a.nz - 1);
  if (cx >= a.nx) cx -= a.nx;
  if (cy >= a.ny) cy -= a.ny;
  if (cz >= a.nz) cz -= a.nz;
  const int cell = (cz * a.ny + cy) * a.nx + cx;
  const bool mover = valid && inside && cell != a.cell_base + col;

  const float ex = subf(px, a.sx0), ey = subf(py, a.sy0), ez = subf(pz, a.sz0);
  const float fx = addf(addf(mulf(a.R[0], ex), mulf(a.R[1], ey)), mulf(a.R[2], ez));
  const float fy = addf(addf(mulf(a.R[3], ex), mulf(a.R[4], ey)), mulf(a.R[5], ez));
  const float fz = addf(addf(mulf(a.R[6], ex), mulf(a.R[7], ey)), mulf(a.R[8], ez));
  const float az = atan2f(fy, fx);
  const float el = atan2f(fz, fx);
  const bool in_fov = fabsf(az) <= a.half_h && fabsf(el) <= a.half_v && fx > 0.0f;
  const int h = clampi((int)floorf(divf(addf(az, a.half_h), a.res)), 0, a.nph - 1);
  const int v = clampi((int)floorf(divf(subf(a.half_v, el), a.res)), 0, a.npv - 1);
  const bool fov = valid && inside && in_fov;
  const bool moving = valid && inside && (vx != 0.0f || vy != 0.0f);
  const int pyr = h * a.npv + v;
  const int packed = (int)mover | ((int)fov << 1) | ((int)moving << 2) |
                     ((int)moved_out << 3) | (pyr << 4);

  a.opx[i] = px;
  a.opy[i] = py;
  a.oflags[i] = moved_out ? 0 : flags;
  a.ocell[i] = cell;
  a.otags[i] = (mover || fov || moving || moved_out) ? packed : 0;
}

}  // namespace

// ptrs: flags px py pz vx vy | opx opy oflags ocell otags
// fparams: dt sx0 sy0 sz0 inv_res half_h half_v res R[9]
// iparams: S V ox oy oz sox soy soz nx ny nz nph npv advance cell_base
DSPMAP_API int dspmap_sweep(const uint64_t* ptrs, const float* f,
                            const int* ip, void* stream) {
  SweepArgs a;
  a.flags = dptr<const int>(ptrs, 0);
  a.px = dptr<const float>(ptrs, 1);
  a.py = dptr<const float>(ptrs, 2);
  a.pz = dptr<const float>(ptrs, 3);
  a.vx = dptr<const float>(ptrs, 4);
  a.vy = dptr<const float>(ptrs, 5);
  a.opx = dptr<float>(ptrs, 6);
  a.opy = dptr<float>(ptrs, 7);
  a.oflags = dptr<int>(ptrs, 8);
  a.ocell = dptr<int>(ptrs, 9);
  a.otags = dptr<int>(ptrs, 10);
  a.dt = f[0]; a.sx0 = f[1]; a.sy0 = f[2]; a.sz0 = f[3];
  a.inv_res = f[4]; a.half_h = f[5]; a.half_v = f[6]; a.res = f[7];
  for (int k = 0; k < 9; ++k) a.R[k] = f[8 + k];
  const int S = ip[0];
  a.V = ip[1];
  a.ox = ip[2]; a.oy = ip[3]; a.oz = ip[4];
  a.sox = ip[5]; a.soy = ip[6]; a.soz = ip[7];
  a.nx = ip[8]; a.ny = ip[9]; a.nz = ip[10];
  a.nph = ip[11]; a.npv = ip[12]; a.advance = ip[13];
  a.cell_base = ip[14];
  a.n = (long long)S * a.V;
  if (a.n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
  sweep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

DSPMAP_API const char* dspmap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
