// pYIN Viterbi decode for NVIDIA Hopper, called from JAX through the XLA FFI.
//
// One thread-block cluster of kCluster CTAs (one per SM) decodes one
// sequence; the leading batch axis of the inputs is the grid.  The frames are
// sequential, so the work of one frame is spread over the cluster: each CTA
// owns a slice of the n target bins, and kParts warps share each target's
// 2w+1 in-band sources.  Every CTA keeps a full copy of both chains' delta
// vectors (voiced / unvoiced) in shared memory, double-buffered and padded by
// -1e30 on both sides; a frame's new deltas are written into every CTA's copy
// through distributed shared memory, and one cluster barrier per frame
// separates the frames.
//
// Semantics are those of core.pyin.viterbi_scan (the dense lax.scan decode),
// bit for bit: only float adds, compares and selects are used.
//   * in-band sources i (|i - j| <= w) score delta[i] + log_local[i, j], read
//     from a compressed band table (sources whose band values are identical
//     share a row, see band_table in __init__.py);
//   * out-of-band sources score delta[i] + log(1e-30), which does not depend
//     on j, so the best of them is the first argmax over all i of
//     s[i] = delta[i] + log_eps, published by the previous frame.  When that
//     argmax falls inside j's band, its in-band score beats its out-of-band
//     score by log(trans) - log(1e-30) > 50 nats, so the band wins;
//   * ties go to the smallest source index, as jnp.argmax does.
// Backpointers (absolute state indices < 2n) go to device memory as int16;
// one thread walks them back at the end of the same launch.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
namespace cg = cooperative_groups;

namespace {

constexpr float kPad = -1e30f;
constexpr int kCluster = 8;  // CTAs per decode (the portable cluster size)
constexpr int kParts = 8;    // warps per 32 target bins, each scans 1/8 band

// First-occurrence argmax merge: larger value wins, ties go to the smaller index.
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    merge(v, i, ov, oi);
  }
}

// Band-table row of source i: rows [0, lo) and [hi, n) are their own, every
// source in [lo, hi) shares row lo.  lo == hi == n means one row per source.
__device__ __forceinline__ int table_row(int i, int lo, int hi) {
  return i < lo ? i : (i < hi ? lo : i - hi + lo + 1);
}

// Block layout: warp = part * tw + target_warp.  The 32 lanes of a warp own
// 32 consecutive target bins, so a step of the band loop reads consecutive
// shared-memory words and one band-table row; the kParts warps of the same
// targets scan consecutive eighths of the band and meet in shared memory.
__global__ void __cluster_dims__(kCluster, 1, 1)
    viterbi_kernel(const float* __restrict__ init_v,
                   const float* __restrict__ init_u,
                   const float* __restrict__ lov, const float* __restrict__ lou,
                   const float* __restrict__ table, int n, int tm1, int w,
                   int lo, int hi, int rows, int tpc, float log_stay,
                   float log_switch, float log_eps, int32_t* __restrict__ states,
                   int16_t* __restrict__ psi) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;

  const int P = n + 2 * w;  // padded delta length
  const int band = 2 * w + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw = (blockDim.x >> 5) / kParts;  // target warps per part
  const int n_slots = kCluster * tw;          // out-of-band partials
  const int part = warp / tw;
  const int jl = (warp % tw) * 32 + lane;
  const int j = rank * tpc + jl;  // this thread's target bin
  const bool active = jl < tpc && j < n;
  const int q = (band + kParts - 1) / kParts;
  const int k_begin = min(part * q, band), k_end = min(k_begin + q, band);
  const int width = tw * 32;

  extern __shared__ float smem[];
  float* delta = smem;                                    // [buf][chain][P]
  int* rowoff = reinterpret_cast<int*>(delta + 4 * P);    // [P]
  float* part_v = reinterpret_cast<float*>(rowoff + P);   // [buf][chain][slot]
  int* part_i = reinterpret_cast<int*>(part_v + 4 * n_slots);
  float* band_v = reinterpret_cast<float*>(part_i + 4 * n_slots);  // [part][chain][jl]
  int* band_k = reinterpret_cast<int*>(band_v + 2 * kParts * width);

  init_v += static_cast<size_t>(b) * n;
  init_u += static_cast<size_t>(b) * n;
  lov += static_cast<size_t>(b) * tm1 * n;
  lou += static_cast<size_t>(b) * tm1;
  states += static_cast<size_t>(b) * (tm1 + 1);
  psi += static_cast<size_t>(b) * tm1 * 2 * n;

  for (int x = tid; x < 4 * P; x += blockDim.x) delta[x] = kPad;
  for (int x = tid; x < P; x += blockDim.x) {
    rowoff[x] = table_row(min(max(x - w, 0), n - 1), lo, hi);
  }
  __syncthreads();
  for (int x = tid; x < n; x += blockDim.x) {
    delta[w + x] = init_v[x];
    delta[P + w + x] = init_u[x];
  }
  cluster.sync();  // every CTA is running before any remote write

  // Part-0 warps publish their argmax of (delta + log_eps) per chain into
  // slot (rank, target warp) of buffer `buf` in every CTA.
  auto publish = [&](int buf, float sv, int iv, float su, int iu) {
    warp_argmax(sv, iv);
    warp_argmax(su, iu);
    if (lane < kCluster) {
      const int slot = rank * tw + warp;
      float* rv = cluster.map_shared_rank(part_v, lane);
      int* ri = cluster.map_shared_rank(part_i, lane);
      rv[(buf * 2 + 0) * n_slots + slot] = sv;
      ri[(buf * 2 + 0) * n_slots + slot] = iv;
      rv[(buf * 2 + 1) * n_slots + slot] = su;
      ri[(buf * 2 + 1) * n_slots + slot] = iu;
    }
  };

  if (part == 0) {
    float sv = -INFINITY, su = -INFINITY;
    int iv = n, iu = n;
    if (active) {
      sv = delta[w + j] + log_eps;
      su = delta[P + w + j] + log_eps;
      iv = iu = j;
    }
    publish(0, sv, iv, su, iu);
  }
  float lov_next = 0.f, lou_next = 0.f;
  if (part == 0 && active && tm1 > 0) {
    lov_next = lov[j];
    lou_next = lou[0];
  }
  cluster.sync();

  for (int t = 0; t < tm1; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* dv = delta + (cur * 2 + 0) * P;
    const float* du = delta + (cur * 2 + 1) * P;

    // this warp's part of the band for its 32 targets
    float mv = -INFINITY, mu = -INFINITY;
    int kv = band, ku = band;
    if (active) {
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k) {
        const float l = __ldg(table + (band - 1 - k) * rows + rowoff[j + k]);
        const float xv = dv[j + k] + l;
        const float xu = du[j + k] + l;
        if (xv > mv) { mv = xv; kv = k; }
        if (xu > mu) { mu = xu; ku = k; }
      }
    }
    band_v[(part * 2 + 0) * width + jl] = mv;
    band_k[(part * 2 + 0) * width + jl] = kv;
    band_v[(part * 2 + 1) * width + jl] = mu;
    band_k[(part * 2 + 1) * width + jl] = ku;
    __syncthreads();

    if (part == 0) {
      const float lov_tj = lov_next, lou_t = lou_next;
      if (active && t + 1 < tm1) {  // prefetch the next frame's observations
        lov_next = lov[static_cast<size_t>(t + 1) * n + j];
        lou_next = lou[t + 1];
      }
      // best out-of-band source of each chain: first argmax over the slots
      float gv = -INFINITY, gu = -INFINITY;
      int giv = n, giu = n;
      for (int s = lane; s < n_slots; s += 32) {
        merge(gv, giv, part_v[(cur * 2 + 0) * n_slots + s],
              part_i[(cur * 2 + 0) * n_slots + s]);
        merge(gu, giu, part_v[(cur * 2 + 1) * n_slots + s],
              part_i[(cur * 2 + 1) * n_slots + s]);
      }
      warp_argmax(gv, giv);
      warp_argmax(gu, giu);

      float sv = -INFINITY, su = -INFINITY;
      int siv = n, siu = n;
      if (active) {
        for (int pp = 1; pp < kParts; ++pp) {
          merge(mv, kv, band_v[(pp * 2 + 0) * width + jl],
                band_k[(pp * 2 + 0) * width + jl]);
          merge(mu, ku, band_v[(pp * 2 + 1) * width + jl],
                band_k[(pp * 2 + 1) * width + jl]);
        }
        int bv = j - w + kv, bu = j - w + ku;
        // out-of-band winner: left of the band wins ties, right of it does not
        if ((giv < j - w && gv >= mv) || (giv > j + w && gv > mv)) { mv = gv; bv = giv; }
        if ((giu < j - w && gu >= mu) || (giu > j + w && gu > mu)) { mu = gu; bu = giu; }

        const float stay = mv + log_stay, sw = mu + log_switch;
        const bool take_stay = stay >= sw;
        const float nv = (take_stay ? stay : sw) + lov_tj;

        const float sw2 = mv + log_switch, st2 = mu + log_stay;
        const bool take_sw = sw2 >= st2;
        const float nu = (take_sw ? sw2 : st2) + lou_t;

#pragma unroll
        for (int r = 0; r < kCluster; ++r) {
          float* rd = cluster.map_shared_rank(delta, r);
          rd[(nxt * 2 + 0) * P + w + j] = nv;
          rd[(nxt * 2 + 1) * P + w + j] = nu;
        }
        const size_t row = static_cast<size_t>(t) * 2 * n;
        psi[row + j] = static_cast<int16_t>(take_stay ? bv : bu + n);
        psi[row + n + j] = static_cast<int16_t>(take_sw ? bv : bu + n);
        sv = nv + log_eps;
        su = nu + log_eps;
        siv = siu = j;
      }
      publish(nxt, sv, siv, su, siu);
    }
    cluster.sync();
  }

  __threadfence();
  cluster.sync();  // every CTA's backpointers are in device memory
  if (rank != 0) return;

  // last state: first argmax of concat(delta_v, delta_u), from this CTA's copy
  const int fin = tm1 & 1;
  float mv = -INFINITY, mu = -INFINITY;
  int iv = n, iu = n;
  for (int x = tid; x < n; x += blockDim.x) {
    merge(mv, iv, delta[(fin * 2 + 0) * P + w + x], x);
    merge(mu, iu, delta[(fin * 2 + 1) * P + w + x], x);
  }
  warp_argmax(mv, iv);
  warp_argmax(mu, iu);
  __shared__ float fin_v[2][32];
  __shared__ int fin_i[2][32];
  if (lane == 0) {
    fin_v[0][warp] = mv;
    fin_i[0][warp] = iv;
    fin_v[1][warp] = mu;
    fin_i[1][warp] = iu;
  }
  __syncthreads();
  if (tid == 0) {
    for (int x = 1; x < static_cast<int>(blockDim.x >> 5); ++x) {
      merge(mv, iv, fin_v[0][x], fin_i[0][x]);
      merge(mu, iu, fin_v[1][x], fin_i[1][x]);
    }
    int s = mv >= mu ? iv : iu + n;
    states[tm1] = s;
    for (int t = tm1 - 1; t >= 0; --t) {
      const size_t row = static_cast<size_t>(t) * 2 * n;
      s = s < n ? psi[row + s] : psi[row + n + (s - n)];
      states[t] = s;
    }
  }
}

ffi::Error ViterbiImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> init_v,
                       ffi::Buffer<ffi::F32> init_u, ffi::Buffer<ffi::F32> lov,
                       ffi::Buffer<ffi::F32> lou, ffi::Buffer<ffi::F32> table,
                       int64_t width, int64_t row_lo, int64_t row_hi,
                       float log_stay, float log_switch, float log_eps,
                       ffi::ResultBuffer<ffi::S32> states,
                       ffi::ResultBuffer<ffi::S16> psi) {
  const auto dims = lov.dimensions();
  if (dims.size() < 2) {
    return ffi::Error::InvalidArgument("log_obs_v must be (..., T-1, n)");
  }
  const int64_t n = dims.back();
  const int64_t tm1 = dims[dims.size() - 2];
  const int64_t batch = tm1 * n ? lov.element_count() / (tm1 * n) : 0;
  const int64_t band = 2 * width + 1;
  const int64_t tpc = (n + kCluster - 1) / kCluster;
  const int64_t tw = (tpc + 31) / 32;
  const int64_t threads = 32 * tw * kParts;
  if (n < 1 || 2 * n > 32767 || threads > 1024 || tm1 < 1 || width < 0 ||
      width >= n || init_v.element_count() != batch * n ||
      init_u.element_count() != batch * n ||
      lou.element_count() != batch * tm1 ||
      table.element_count() % band != 0 ||
      states->element_count() != batch * (tm1 + 1) ||
      psi->element_count() != batch * tm1 * 2 * n) {
    return ffi::Error::InvalidArgument("aegis_viterbi: inconsistent shapes");
  }
  if (batch == 0) return ffi::Error::Success();
  const int64_t P = n + 2 * width;
  const int64_t n_slots = kCluster * tw;
  const size_t shmem = 4 * P * sizeof(float) + P * sizeof(int) +
                       4 * n_slots * (sizeof(float) + sizeof(int)) +
                       2 * kParts * 32 * tw * (sizeof(float) + sizeof(int));
  viterbi_kernel<<<static_cast<unsigned>(batch * kCluster),
                   static_cast<unsigned>(threads), shmem, stream>>>(
      init_v.typed_data(), init_u.typed_data(), lov.typed_data(),
      lou.typed_data(), table.typed_data(), static_cast<int>(n),
      static_cast<int>(tm1), static_cast<int>(width), static_cast<int>(row_lo),
      static_cast<int>(row_hi), static_cast<int>(table.element_count() / band),
      static_cast<int>(tpc), log_stay, log_switch, log_eps,
      states->typed_data(), psi->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(AegisViterbi, ViterbiImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // init_v
                                  .Arg<ffi::Buffer<ffi::F32>>()  // init_u
                                  .Arg<ffi::Buffer<ffi::F32>>()  // log_obs_v[1:]
                                  .Arg<ffi::Buffer<ffi::F32>>()  // log_obs_u[1:]
                                  .Arg<ffi::Buffer<ffi::F32>>()  // band table
                                  .Attr<int64_t>("width")
                                  .Attr<int64_t>("row_lo")
                                  .Attr<int64_t>("row_hi")
                                  .Attr<float>("log_stay")
                                  .Attr<float>("log_switch")
                                  .Attr<float>("log_eps")
                                  .Ret<ffi::Buffer<ffi::S32>>()   // states
                                  .Ret<ffi::Buffer<ffi::S16>>()); // backpointers
