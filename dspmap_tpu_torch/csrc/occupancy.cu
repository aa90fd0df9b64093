// Occupancy pool pass: cull, per-voxel aggregates and systematic resample
// (replaces dspmap_tpu/ops/pallas/occupancy.py::occupancy_pool_pass; spec:
// dspmap_tpu/ops/occupancy.py::_pool_pass_xla, plain version
// dspmap_tpu_torch/ops/occupancy.py::pool_pass_plain).
//
// Bound on the H100: memory.  Every voxel column is read once (flags,
// weight, px/py/pz, the carried velocity planes) and written once; the
// resample's O(S^2) copy-placement sweep is a few hundred register
// operations per voxel, small beside ~70 bytes per slot of traffic.
// Design: one thread per voxel column v, reading plane[s*V + v] for
// s = 0..S-1, so a warp's 32 loads of one slot row hit 128 contiguous
// bytes.  The column lives in per-thread arrays sized by the template
// parameter S (fully unrolled).  Every float sum associates as the plain
// version does, because the placement thresholds ceil(x/wa - 1/2) turn a
// different association into flag flips: sums run in slot order, and the
// weight cumsum runs in slot order within blocks of kScanBlock slots plus
// the earlier blocks' total (the association of the XLA reference).
//
// Two forms of the same arithmetic.  occupancy_kernel<S> (S = 18) keeps the
// column in registers and unrolls everything, the S^2 copy-placement
// sweep included.  At S = 50 or 60 that would be thousands of unrolled
// compares and selects per thread, so occupancy_kernel_deep<S> runs plain
// loops over three per-thread arrays in local memory (weight, demand_end
// and a byte of state bits per slot; local memory interleaves threads, so
// a warp's access to one slot is one 128-byte line), finds a filled slot's
// source by binary search in the non-decreasing demand_end, and reads the
// source's payload straight from the input plane (a line its warp reads
// anyway).  The integer results cannot differ; every float operation is the
// same one in the same order.  The per-voxel totals (weight sum, velocity
// sums, static contribution) of 33..64 slots are formed as the plain version
// forms them: the first ceil(S/2) slots and the rest, each in slot order,
// then the two added (ops/occupancy.py::sum_split).
#include "common.cuh"

namespace {

constexpr int kMaxVel = 3;
constexpr int kScanBlock = 16;  // = ops/occupancy.py SCAN_BLOCK

struct OccArgs {
  const int* flags;
  const float *w, *px, *py, *pz, *t;
  const float* vel[kMaxVel];
  int* oflags;
  float *ow, *opx, *opy, *opz, *ot;
  float* ovel[kMaxVel];
  uint8_t* omoving;  // [S, V] bool, may be null
  // per-voxel [V] outputs
  float *ws, *n_old, *static_c, *n_valid, *n_culled, *do_rs, *n_dropped,
      *n_filled;
  float* vsum[kMaxVel];
  int V, n_vel, resample_min, max_ppv;
  float cull;
};

template <int S>
__global__ void __launch_bounds__(128) occupancy_kernel(OccArgs a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.V) return;
  const long long V = a.V;

  int fl[S];
  float w[S];
  bool valid[S], old[S], cull[S];
  float ws = 0.0f, nold = 0.0f, stat = 0.0f, nvalid = 0.0f, nculled = 0.0f;
  float vs[kMaxVel] = {0.0f, 0.0f, 0.0f};
  int count = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int f0 = a.flags[s * V + v];
    const float ww = a.w[s * V + v];
    const bool c = f0 != 0 && ww < a.cull;
    const int f = c ? 0 : f0;
    fl[s] = f;
    w[s] = ww;
    cull[s] = c;
    valid[s] = f != 0;
    old[s] = valid[s] && f != 3;
    bool mv = false;
    for (int k = 0; k < a.n_vel; ++k) {
      const float vv = a.vel[k][s * V + v];
      mv = mv || vv != 0.0f;
      vs[k] = addf(vs[k], old[s] ? vv : 0.0f);
    }
    const bool moving = old[s] && mv;
    if (a.omoving) a.omoving[s * V + v] = moving ? 1 : 0;
    ws = addf(ws, valid[s] ? ww : 0.0f);
    nold += old[s] ? 1.0f : 0.0f;
    stat = addf(stat, (old[s] && !moving) ? ww : 0.0f);
    count += valid[s] ? 1 : 0;
    nculled += c ? 1.0f : 0.0f;
  }
  nvalid = (float)count;
  const bool do_rs = count >= a.resample_min;

  a.ws[v] = ws;
  a.n_old[v] = nold;
  a.static_c[v] = stat;
  a.n_valid[v] = nvalid;
  a.n_culled[v] = nculled;
  a.do_rs[v] = do_rs ? 1.0f : 0.0f;
  for (int k = 0; k < a.n_vel; ++k) a.vsum[k][v] = vs[k];

  if (!do_rs) {
    // copies == 0 for every slot: cull + newborn reset, payload unchanged
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a.oflags[s * V + v] = valid[s] ? 1 : fl[s];
      a.ow[s * V + v] = w[s];
      a.opx[s * V + v] = a.px[s * V + v];
      a.opy[s * V + v] = a.py[s * V + v];
      a.opz[s * V + v] = a.pz[s * V + v];
      for (int k = 0; k < a.n_vel; ++k) a.ovel[k][s * V + v] = a.vel[k][s * V + v];
      if (a.ot) a.ot[s * V + v] = a.t[s * V + v];
    }
    a.n_dropped[v] = 0.0f;
    a.n_filled[v] = 0.0f;
    return;
  }

  // ---- systematic resample (dsp_dynamic.h:986-1055) ----------------------
  const int n_target = count < a.max_ppv ? count : a.max_ppv;
  const float wa = divf(ws, (float)(n_target > 1 ? n_target : 1));
  int extra[S], free_rank[S];
  bool kept[S], dropped[S], is_free[S];
  float base = 0.0f, blk = 0.0f;
  int free_cum = 0, demand = 0;
  int demand_end[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float wv = valid[s] ? w[s] : 0.0f;
    if (s % kScanBlock == 0) {
      blk = wv;
    } else {
      blk = addf(blk, wv);
    }
    // block 0 has base 0, and 0 + x == x exactly
    const float hi = addf(base, blk);
    if (s % kScanBlock == kScanBlock - 1) base = hi;
    const float lo = subf(hi, wv);
    const float g_hi = fmaxf(ceilf(subf(divf(hi, wa), 0.5f)), 0.0f);
    const float g_lo = fmaxf(ceilf(subf(divf(lo, wa), 0.5f)), 0.0f);
    const int copies = valid[s] ? (int)g_hi - (int)g_lo : 0;
    kept[s] = valid[s] && copies >= 1;
    dropped[s] = valid[s] && copies == 0;
    extra[s] = copies - 1 > 0 ? copies - 1 : 0;
    is_free[s] = !valid[s] || dropped[s];
    free_rank[s] = free_cum;
    free_cum += is_free[s] ? 1 : 0;
    demand += extra[s];
    demand_end[s] = demand;
  }
  const int total_free = free_cum, total_extra = demand;
  const int lim = total_extra < total_free ? total_extra : total_free;

  float n_dropped = 0.0f, n_filled = 0.0f;
  int src[S];
  bool filled[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int j = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) j += demand_end[k] <= free_rank[s] ? 1 : 0;
    src[s] = j < S ? j : S - 1;
    filled[s] = is_free[s] && free_rank[s] < lim;
    const int demand_start = demand_end[s] - extra[s];
    int placed = total_free - demand_start;
    placed = placed < 0 ? 0 : (placed > extra[s] ? extra[s] : placed);
    const float unplaced = (float)(extra[s] - placed);
    float nw = kept[s] ? mulf(wa, addf(1.0f, unplaced)) : w[s];
    if (filled[s]) nw = wa;
    int nf = valid[s] ? 1 : fl[s];
    if (dropped[s]) nf = 0;
    if (filled[s]) nf = 1;
    a.oflags[s * V + v] = nf;
    a.ow[s * V + v] = nw;
    n_dropped += (dropped[s] && !filled[s]) ? 1.0f : 0.0f;
    n_filled += (filled[s] && !valid[s]) ? 1.0f : 0.0f;
  }
  a.n_dropped[v] = n_dropped;
  a.n_filled[v] = n_filled;

  // payload placement: filled slots copy their source particle's fields
  const float* in[3 + kMaxVel + 1] = {a.px, a.py, a.pz, nullptr, nullptr,
                                      nullptr, nullptr};
  float* out[3 + kMaxVel + 1] = {a.opx, a.opy, a.opz, nullptr, nullptr,
                                 nullptr, nullptr};
  int n_fields = 3;
  for (int k = 0; k < a.n_vel; ++k) {
    in[n_fields] = a.vel[k];
    out[n_fields] = a.ovel[k];
    ++n_fields;
  }
  if (a.ot) {
    in[n_fields] = a.t;
    out[n_fields] = a.ot;
    ++n_fields;
  }
  for (int f = 0; f < n_fields; ++f) {
    float col[S];
#pragma unroll
    for (int s = 0; s < S; ++s) col[s] = in[f][s * V + v];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float x = col[0];
#pragma unroll
      for (int j = 1; j < S; ++j) x = src[s] == j ? col[j] : x;
      out[f][s * V + v] = filled[s] ? x : col[s];
    }
  }
}

template <int S>
__global__ void __launch_bounds__(64) occupancy_kernel_deep(OccArgs a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.V) return;
  const long long V = a.V;
  constexpr unsigned char kValid = 1, kKept = 2, kDropped = 4;

  static_assert(S > 32 && S <= 64, "the totals split in two for 33..64 slots");
  constexpr int kSplit = (S + 1) / 2;  // = ops/occupancy.py sum_split(S)
  float w[S];
  int demand_end[S];
  unsigned char st[S];
  float ws = 0.0f, nold = 0.0f, stat = 0.0f, nculled = 0.0f;
  float vs[kMaxVel] = {0.0f, 0.0f, 0.0f};
  float ws0 = 0.0f, stat0 = 0.0f, vs0[kMaxVel] = {0.0f, 0.0f, 0.0f};
  int count = 0;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    if (s == kSplit) {  // park the first half's totals, start the second
      ws0 = ws, stat0 = stat, ws = 0.0f, stat = 0.0f;
      for (int k = 0; k < kMaxVel; ++k) vs0[k] = vs[k], vs[k] = 0.0f;
    }
    const int f0 = a.flags[s * V + v];
    const float ww = a.w[s * V + v];
    const bool c = f0 != 0 && ww < a.cull;
    const int f = c ? 0 : f0;
    const bool valid = f != 0;
    const bool old = valid && f != 3;
    w[s] = ww;
    st[s] = valid ? kValid : 0;
    bool mv = false;
    for (int k = 0; k < a.n_vel; ++k) {
      const float vv = a.vel[k][s * V + v];
      mv = mv || vv != 0.0f;
      vs[k] = addf(vs[k], old ? vv : 0.0f);
    }
    const bool moving = old && mv;
    if (a.omoving) a.omoving[s * V + v] = moving ? 1 : 0;
    ws = addf(ws, valid ? ww : 0.0f);
    nold += old ? 1.0f : 0.0f;
    stat = addf(stat, (old && !moving) ? ww : 0.0f);
    count += valid ? 1 : 0;
    nculled += c ? 1.0f : 0.0f;
  }
  const bool do_rs = count >= a.resample_min;
  ws = addf(ws0, ws);
  stat = addf(stat0, stat);
  for (int k = 0; k < kMaxVel; ++k) vs[k] = addf(vs0[k], vs[k]);

  a.ws[v] = ws;
  a.n_old[v] = nold;
  a.static_c[v] = stat;
  a.n_valid[v] = (float)count;
  a.n_culled[v] = nculled;
  a.do_rs[v] = do_rs ? 1.0f : 0.0f;
  for (int k = 0; k < a.n_vel; ++k) a.vsum[k][v] = vs[k];

  const float* in[3 + kMaxVel + 1] = {a.px, a.py, a.pz, nullptr, nullptr,
                                      nullptr, nullptr};
  float* out[3 + kMaxVel + 1] = {a.opx, a.opy, a.opz, nullptr, nullptr,
                                 nullptr, nullptr};
  int n_fields = 3;
  for (int k = 0; k < a.n_vel; ++k) {
    in[n_fields] = a.vel[k];
    out[n_fields] = a.ovel[k];
    ++n_fields;
  }
  if (a.ot) {
    in[n_fields] = a.t;
    out[n_fields] = a.ot;
    ++n_fields;
  }

  if (!do_rs) {
    // copies == 0 for every slot: cull + newborn reset, payload unchanged
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      a.oflags[s * V + v] = (st[s] & kValid) ? 1 : 0;
      a.ow[s * V + v] = w[s];
      for (int f = 0; f < n_fields; ++f) out[f][s * V + v] = in[f][s * V + v];
    }
    a.n_dropped[v] = 0.0f;
    a.n_filled[v] = 0.0f;
    return;
  }

  // ---- systematic resample (dsp_dynamic.h:986-1055) ----------------------
  const int n_target = count < a.max_ppv ? count : a.max_ppv;
  const float wa = divf(ws, (float)(n_target > 1 ? n_target : 1));
  float base = 0.0f, blk = 0.0f;
  int total_free = 0, demand = 0;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const bool valid = st[s] & kValid;
    const float wv = valid ? w[s] : 0.0f;
    if (s % kScanBlock == 0) {
      blk = wv;
    } else {
      blk = addf(blk, wv);
    }
    // block 0 has base 0, and 0 + x == x exactly
    const float hi = addf(base, blk);
    if (s % kScanBlock == kScanBlock - 1) base = hi;
    const float lo = subf(hi, wv);
    const float g_hi = fmaxf(ceilf(subf(divf(hi, wa), 0.5f)), 0.0f);
    const float g_lo = fmaxf(ceilf(subf(divf(lo, wa), 0.5f)), 0.0f);
    const int copies = valid ? (int)g_hi - (int)g_lo : 0;
    const bool kept = valid && copies >= 1;
    const bool dropped = valid && copies == 0;
    st[s] = (valid ? kValid : 0) | (kept ? kKept : 0) | (dropped ? kDropped : 0);
    total_free += (!valid || dropped) ? 1 : 0;
    demand += copies - 1 > 0 ? copies - 1 : 0;
    demand_end[s] = demand;
  }
  const int total_extra = demand;
  const int lim = total_extra < total_free ? total_extra : total_free;

  float n_dropped = 0.0f, n_filled = 0.0f;
  int free_rank = 0, demand_start = 0;
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const bool valid = st[s] & kValid, kept = st[s] & kKept,
               dropped = st[s] & kDropped;
    const bool is_free = !valid || dropped;
    const bool filled = is_free && free_rank < lim;
    const int extra = demand_end[s] - demand_start;
    int placed = total_free - demand_start;
    placed = placed < 0 ? 0 : (placed > extra ? extra : placed);
    const float unplaced = (float)(extra - placed);
    float nw = kept ? mulf(wa, addf(1.0f, unplaced)) : w[s];
    if (filled) nw = wa;
    int nf = valid ? 1 : 0;
    if (dropped) nf = 0;
    if (filled) nf = 1;
    a.oflags[s * V + v] = nf;
    a.ow[s * V + v] = nw;
    n_dropped += (dropped && !filled) ? 1.0f : 0.0f;
    n_filled += (filled && !valid) ? 1.0f : 0.0f;

    // payload: a filled slot copies its source particle, the slot j with
    // j = #{k : demand_end[k] <= free_rank} (demand_end is non-decreasing)
    int src = s;
    if (filled) {
      int lo = 0, hi = S;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (demand_end[mid] <= free_rank) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      src = lo < S ? lo : S - 1;
    }
    for (int f = 0; f < n_fields; ++f) out[f][s * V + v] = in[f][src * V + v];

    free_rank += is_free ? 1 : 0;
    demand_start = demand_end[s];
  }
  a.n_dropped[v] = n_dropped;
  a.n_filled[v] = n_filled;
}

template <int S>
int launch_deep(const OccArgs& a, cudaStream_t stream) {
  const int threads = 64;
  const unsigned blocks = (unsigned)((a.V + threads - 1) / threads);
  occupancy_kernel_deep<S><<<blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const OccArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((a.V + threads - 1) / threads);
  occupancy_kernel<S><<<blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: flags w px py pz t vel0 vel1 vel2 | oflags ow opx opy opz ot ovel0
//       ovel1 ovel2 omoving | ws n_old static n_valid n_culled do_rs
//       n_dropped n_filled vsum0 vsum1 vsum2     (unused entries are 0)
// fparams: weight_cull_threshold
// iparams: S V n_vel resample_min_count max_particles_per_voxel
DSPMAP_API int dspmap_occupancy_pool_pass(const uint64_t* p, const float* f,
                                          const int* ip, void* stream) {
  OccArgs a;
  a.flags = dptr<const int>(p, 0);
  a.w = dptr<const float>(p, 1);
  a.px = dptr<const float>(p, 2);
  a.py = dptr<const float>(p, 3);
  a.pz = dptr<const float>(p, 4);
  a.t = dptr<const float>(p, 5);
  for (int k = 0; k < kMaxVel; ++k) a.vel[k] = dptr<const float>(p, 6 + k);
  a.oflags = dptr<int>(p, 9);
  a.ow = dptr<float>(p, 10);
  a.opx = dptr<float>(p, 11);
  a.opy = dptr<float>(p, 12);
  a.opz = dptr<float>(p, 13);
  a.ot = dptr<float>(p, 14);
  for (int k = 0; k < kMaxVel; ++k) a.ovel[k] = dptr<float>(p, 15 + k);
  a.omoving = dptr<uint8_t>(p, 18);
  a.ws = dptr<float>(p, 19);
  a.n_old = dptr<float>(p, 20);
  a.static_c = dptr<float>(p, 21);
  a.n_valid = dptr<float>(p, 22);
  a.n_culled = dptr<float>(p, 23);
  a.do_rs = dptr<float>(p, 24);
  a.n_dropped = dptr<float>(p, 25);
  a.n_filled = dptr<float>(p, 26);
  for (int k = 0; k < kMaxVel; ++k) a.vsum[k] = dptr<float>(p, 27 + k);
  a.cull = f[0];
  const int S = ip[0];
  a.V = ip[1];
  a.n_vel = ip[2];
  a.resample_min = ip[3];
  a.max_ppv = ip[4];
  if (a.V == 0) return 0;
  switch (S) {
    case 18:
      return launch<18>(a, (cudaStream_t)stream);
    case 50:
      return launch_deep<50>(a, (cudaStream_t)stream);
    case 60:
      return launch_deep<60>(a, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
