// DCNv3 forward sampling, float32, channels-last: x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK) -> out (B, Ho, Wo, C).
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_impl
// (pallas_call at :252). That kernel keeps a band of input rows in VMEM and, since the TPU
// has no per-lane gather, folds the kk bilinear samples of each output row into a one-hot
// matrix over the band; a lax.cond sends the whole call to the plain core when any sample
// leaves the band. Here the band becomes a window of the input in shared memory, one per
// block, and a sample that leaves the window is read from device memory inside the kernel,
// sample by sample: exact for any offset, with no second path.
//
// Bound: memory bytes. x is read once, offset and mask once, out written once: at
// 32 x 80 x 80 x 64 that is 52.4 + 14.7 + 7.4 + 52.4 = 127 MB, ~38 us at 3.35 TB/s; the
// arithmetic, 11 FLOP per output value and point, takes less at the float32 rate. A direct
// gather (the kernel before this design) makes 36 scalar corner loads per output value, which
// go through L1/L2 and kept it at 8-9% of that bound. At batch 1 a call moves 1-4 MB and is
// bound by its launch and by the host wrapper, not by the device.
//
// Design (dcnv3_common.cuh holds the geometry, the plan and the staging): a block owns one
// image, one group and a tile of output pixels (the plan, kernels/dcn_sampling.py:dcnv3_plan).
// 1. For each chunk of CC channels of the group (at most 128), it copies the window of x
//    (the tile's zero-offset footprint, the +1 corner and a margin) into shared memory with
//    cp.async, 16 bytes a copy where the channels allow; rows and columns outside the image
//    are the copy's zero fill, which is the zero padding. Where a group's tiles alone would
//    leave the card's 132 SMs under-filled, the plan spreads the chunks over blocks.
// 2. While the first chunk's copy flies it computes each pixel's kk samples into shared
//    memory, with csrc/dcnv3_bwd.cu's arithmetic bit for bit.
// 3. The lanes of a warp run along the channels of one output pixel at a time, or of two
//    (16 lanes each) when a chunk has at most 64 channels: each lane V = 4 or 2 neighbouring
//    channels, read from the window and written as one 16- or 8-byte word, where the chunk
//    allows (else one channel a lane, up to four 32 apart). A lane sums over the kk points,
//    in the plain version's order (kk, then the corners as it blends them), in registers. A
//    corner in the window is read from shared memory; one outside it, from device memory
//    with the range check that gives zero padding.
// Measured (torch.profiler's device time, chip_smoke.py --device-times, on an H100 SXM at
// 700 W; PERF.md): at bs 32 0.155 / 0.086 / 0.048 ms at 80x80x64 / 40x40x128 / 20x20x256
// against 0.416 / 0.203 / 0.103 for the direct gather, 24% of the byte bound at 80x80x64.
// About 5-11% of the samples of offsets N(0, 1.5 px) leave their window, 2-39% of a trained
// model's, whose small maps then take up to 40% longer. At batch 1 a call takes 0.012 /
// 0.009 / 0.007 ms on the card (the direct gather 0.016 / 0.009 / 0.006, faster on the
// smallest map) and several times that on the host.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include "dcnv3_common.cuh"

namespace {

using dcnv3::Corners;
using dcnv3::Plan;
using dcnv3::Geometry;
using dcnv3::Sample;

constexpr int kLaneChannels = 4;  // V = 1: channels a lane, lane, lane + 32, lane + 64, lane + 96

template <int V>
__device__ __forceinline__ void load_vec(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

// V = 4 or 2: a lane holds V neighbouring channels and a warp P pixels (chunks of up to
// 32*V/P channels, a multiple of V); V = 1: up to kLaneChannels channels 32 apart (chunks of
// up to 128, any count), a warp one pixel.
template <int V, int P>
__global__ void __launch_bounds__(dcnv3::kThreads) dcnv3_sampling_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, float* __restrict__ out,
    int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale, Plan pl,
    int n_tx, int n_ty, int n_cb, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KK = K * K, GK = G * KK;
  const int npix = pl.th * pl.tw;
  Geometry geo(smem, npix * KK);
  float* win = reinterpret_cast<float*>(smem + Geometry::bytes((size_t)npix * KK));

  long long bid = blockIdx.x;
  const int cb = (int)(bid % n_cb); bid /= n_cb;
  const int tx = (int)(bid % n_tx); bid /= n_tx;
  const int ty = (int)(bid % n_ty); bid /= n_ty;
  const int g = (int)(bid % G);
  const long long b = bid / G;
  const int oy0 = ty * pl.th, ox0 = tx * pl.tw;
  const int wy0 = dcnv3::window_row(row0, oy0, stride, pl);
  const int wx0 = ox0 * stride + pl.win_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  const float* xb = x + b * H * W * C + g * GC;
  const int n_chunks = (GC + pl.cc - 1) / pl.cc;
  const int ci_end = min(n_chunks, (cb + 1) * pl.cpb);
  const int row = pl.ww * pl.cc;  // one window row, in floats
  // 1. the first chunk's window of x, copied while the geometry is computed
  dcnv3::stage_window(win, xb, cb * pl.cpb * pl.cc, min(pl.cc, GC - cb * pl.cpb * pl.cc), wy0,
                      wx0, pl, H, W, C, vec);
  // 2. sample geometry of the tile, one (pixel, point) per thread step
  for (int e = threadIdx.x; e < npix * KK; e += blockDim.x) {
    const int q = e / KK, p = e % KK;
    const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
    Sample s = dcnv3::empty_sample();
    if (oy < Ho && ox < Wo) {
      s = dcnv3::make_sample(offset, mask, (b * Ho + oy) * Wo + ox, g * KK + p, GK, K,
                             row0 + oy, ox, H, W, stride, pad, dil, offset_scale);
      dcnv3::place(s, wy0, wx0, pl);
    }
    geo.store(e, s);
  }

  for (int ci = cb * pl.cpb; ci < ci_end; ++ci) {
    const int c0 = ci * pl.cc, ncur = min(pl.cc, GC - c0);
    dcnv3::cp_async_wait_all();
    __syncthreads();  // the geometry and this chunk's window in place
    // 3. mask-weighted bilinear sums, lanes along the channels of a pixel
    const float* xc = xb + c0;
    if (V > 1) {  // P pixels a warp, each lane V neighbouring channels as one word
      constexpr int L = 32 / P;  // lanes a pixel
      const int ch = V * (lane % L);
      for (int q = warp * P + lane / L; q < npix; q += nwarps * P) {
        const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
        if (oy >= Ho || ox >= Wo || ch >= ncur) continue;  // ncur is a multiple of V
        float acc[V] = {};
        Sample next = geo.load(q * KK);
        for (int p = 0; p < KK; ++p) {
          const Sample s = next;
          if (p + 1 < KK) next = geo.load(q * KK + p + 1);  // in flight while s is summed
          float v[4][V];
          if (s.wofs >= 0) {  // fast path: the four corners in the window
            const float* w0 = win + s.wofs + ch;
            load_vec<V>(v[0], w0);
            load_vec<V>(v[1], w0 + pl.cc);
            load_vec<V>(v[2], w0 + row);
            load_vec<V>(v[3], w0 + row + pl.cc);
          } else {  // a corner outside the window
            const Corners k = dcnv3::locate(geo.corner[q * KK + p], wy0, wx0, pl, H, W);
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int i = 0; i < V; ++i)
                v[c][i] = dcnv3::corner_value(k, c, win, xc, pl.cc, C, ch + i);
          }
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float u[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
            acc[i] += dcnv3::blend(u, s) * s.m;
          }
        }
        store_vec<V>(out + ((b * Ho + oy) * Wo + ox) * C + g * GC + c0 + ch, acc);
      }
    } else {
      for (int q = warp; q < npix; q += nwarps) {
        const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
        if (oy >= Ho || ox >= Wo) continue;  // uniform across the warp
        float* op = out + ((b * Ho + oy) * Wo + ox) * C + g * GC + c0;
        float acc[kLaneChannels] = {};  // V = 1: channels lane, lane + 32, ...
        for (int p = 0; p < KK; ++p) {
          const Sample s = geo.load(q * KK + p);
          if (s.wofs >= 0) {  // fast path: the four corners in the window
            const float* w0 = win + s.wofs;
#pragma unroll
            for (int j = 0; j < kLaneChannels; ++j) {
              const int ch = lane + 32 * j;
              if (ch < ncur) {
                const float v[4] = {w0[ch], w0[ch + pl.cc], w0[ch + row], w0[ch + row + pl.cc]};
                acc[j] += dcnv3::blend(v, s) * s.m;
              }
            }
          } else {  // a corner outside the window
            const Corners k = dcnv3::locate(geo.corner[q * KK + p], wy0, wx0, pl, H, W);
#pragma unroll
            for (int j = 0; j < kLaneChannels; ++j) {
              const int ch = lane + 32 * j;
              if (ch < ncur) {
                float v[4];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  v[c] = dcnv3::corner_value(k, c, win, xc, pl.cc, C, ch);
                acc[j] += dcnv3::blend(v, s) * s.m;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kLaneChannels; ++j)
          if (lane + 32 * j < ncur) op[lane + 32 * j] = acc[j];
      }
    }
    if (ci + 1 < ci_end) {
      __syncthreads();  // the window read: copy the next chunk's
      dcnv3::stage_window(win, xb, c0 + pl.cc, min(pl.cc, GC - c0 - pl.cc), wy0, wx0, pl, H, W, C,
                          vec);
    }
  }
}

int allowed_shared[4][64];  // per kernel and device: the most shared memory allowed so far

}  // namespace

extern "C" int dcnv3_sampling_launch(
    const void* x, const void* offset, const void* mask, void* out,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale,
    int th, int tw, int cc, int cpb, int win_off, int wh, int ww, void* stream) {
  const Plan pl{th, tw, cc, cpb, win_off, wh, ww};
  int rc = dcnv3::check_call(B, H, W, C, Ho, Wo, G, GC, K, stride, dil, pl, 32 * kLaneChannels);
  if (rc) return rc;
  if (row0 < 0) return (int)cudaErrorInvalidValue;
  const int n_ty = (Ho + th - 1) / th, n_tx = (Wo + tw - 1) / tw;
  const int n_chunks = (GC + cc - 1) / cc, n_cb = (n_chunks + cpb - 1) / cpb;
  const long long blocks = (long long)B * G * n_ty * n_tx * n_cb;
  const size_t shared = dcnv3::Geometry::bytes((size_t)th * tw * K * K) +
                        (size_t)wh * ww * cc * sizeof(float);
  if ((rc = dcnv3::check_size(blocks, shared))) return rc;
  const bool vec = cc % 4 == 0 && GC % 4 == 0 && ((uintptr_t)x & 15) == 0;
  // V neighbouring channels a lane where every chunk and the output's addresses allow it; two
  // pixels a warp where 16 lanes of 4 cover a chunk
  const bool v4 = cc % 4 == 0 && GC % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const bool v2 = cc <= 64 && cc % 2 == 0 && GC % 2 == 0 && ((uintptr_t)out & 7) == 0;
  const int form = v4 ? (cc <= 64 ? 0 : 1) : v2 ? 2 : 3;
  auto kernel = form == 0 ? dcnv3_sampling_kernel<4, 2>
                : form == 1 ? dcnv3_sampling_kernel<4, 1>
                : form == 2 ? dcnv3_sampling_kernel<2, 1> : dcnv3_sampling_kernel<1, 1>;
  if ((rc = dcnv3::allow_shared(kernel, shared, allowed_shared[form]))) return rc;
  kernel<<<(unsigned)blocks, dcnv3::kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask, (float*)out,
      H, W, C, Ho, Wo, G, GC, K, stride, pad, dil, row0, offset_scale, pl, n_tx, n_ty, n_cb,
      vec);
  return (int)cudaGetLastError();
}

extern "C" const char* dcnv3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
