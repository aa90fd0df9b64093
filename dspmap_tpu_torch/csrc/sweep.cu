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
// and every load and store is coalesced.  The frame's values -- dt, the
// sensor position, the rotation R, the window origin and origin % dims --
// are read through pointers into the step's two device frame blocks (f32
// and i32), as the Pallas kernel reads scal_ref / iscal_ref, so a launch
// captured in a CUDA graph reads each replayed frame's; the configuration's
// constants ride in the by-value struct.  vz is not read: under
// limit_motion_to_xy_plane (the only configurations that take the fused
// sweep with a nonzero velocity) vz is identically zero, so pz does not
// advance and the moving test reduces to vx/vy -- as in the Pallas kernel.
#include "common.cuh"

namespace {

struct SweepArgs {
  const int* flags;
  const float *px, *py, *pz, *vx, *vy;
  float *opx, *opy;
  int *oflags, *ocell, *otags;
  // the frame's values, in device memory
  const float *dt, *spos, *R;
  const int *origin, *origin_mod;
  long long n;  // S * V
  int V;
  float inv_res, half_h, half_v, res;
  int nx, ny, nz, nph, npv, advance;
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
  const float dt = __ldg(a.dt);
  const float sx0 = __ldg(a.spos), sy0 = __ldg(a.spos + 1),
              sz0 = __ldg(a.spos + 2);
  float R[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(a.R + k);
  const int ox = __ldg(a.origin), oy = __ldg(a.origin + 1),
            oz = __ldg(a.origin + 2);
  const int sox = __ldg(a.origin_mod), soy = __ldg(a.origin_mod + 1),
            soz = __ldg(a.origin_mod + 2);
  if (a.advance && valid) {
    px = addf(px, mulf(vx, dt));
    py = addf(py, mulf(vy, dt));
  }
  const int wx = (int)floorf(mulf(px, a.inv_res));
  const int wy = (int)floorf(mulf(py, a.inv_res));
  const int wz = (int)floorf(mulf(pz, a.inv_res));
  const int rx = wx - ox, ry = wy - oy, rz = wz - oz;
  const bool inside = rx >= 0 && rx < a.nx && ry >= 0 && ry < a.ny &&
                      rz >= 0 && rz < a.nz;
  const bool moved_out = valid && !inside;

  // floor-mod storage cell: mod(origin, dims) is precomputed on the host
  // (the frame block's) and folded back by one conditional subtract (C's %
  // truncates)
  int cx = sox + clampi(rx, 0, a.nx - 1);
  int cy = soy + clampi(ry, 0, a.ny - 1);
  int cz = soz + clampi(rz, 0, a.nz - 1);
  if (cx >= a.nx) cx -= a.nx;
  if (cy >= a.ny) cy -= a.ny;
  if (cz >= a.nz) cz -= a.nz;
  const int cell = (cz * a.ny + cy) * a.nx + cx;
  const bool mover = valid && inside && cell != a.cell_base + col;

  const float ex = subf(px, sx0), ey = subf(py, sy0), ez = subf(pz, sz0);
  const float fx = addf(addf(mulf(R[0], ex), mulf(R[1], ey)), mulf(R[2], ez));
  const float fy = addf(addf(mulf(R[3], ex), mulf(R[4], ey)), mulf(R[5], ez));
  const float fz = addf(addf(mulf(R[6], ex), mulf(R[7], ey)), mulf(R[8], ez));
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

// ptrs: flags px py pz vx vy | opx opy oflags ocell otags |
//       dt sensor_pos[3] R[9] (f32), origin[3] origin_mod[3] (i32)
// fparams: inv_res half_h half_v res
// iparams: S V nx ny nz nph npv advance cell_base
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
  a.dt = dptr<const float>(ptrs, 11);
  a.spos = dptr<const float>(ptrs, 12);
  a.R = dptr<const float>(ptrs, 13);
  a.origin = dptr<const int>(ptrs, 14);
  a.origin_mod = dptr<const int>(ptrs, 15);
  a.inv_res = f[0]; a.half_h = f[1]; a.half_v = f[2]; a.res = f[3];
  const int S = ip[0];
  a.V = ip[1];
  a.nx = ip[2]; a.ny = ip[3]; a.nz = ip[4];
  a.nph = ip[5]; a.npv = ip[6]; a.advance = ip[7];
  a.cell_base = ip[8];
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
