// DCNv3 sampling backward, float32, channels-last: given x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK) and the output gradient
// gout (B, Ho, Wo, C), writes dx (B, H, W, C; zeroed by the caller, accumulated here),
// doffset (B, Ho, Wo, G*KK*2) and dmask (B, Ho, Wo, G*KK).
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_bwd
// (pallas_call at :437). That kernel keeps a band of input rows in VMEM, gathers the corner
// values as one-hot matmuls over it and scatters dx as their transpose into the band, which
// its sequential grid revisits; a lax.cond sends the whole call to the plain backward when an
// offset leaves the band. Here the band becomes a window of the input in shared memory, one
// per block, that holds this block's part of dx; a corner outside the window is handled inside
// the kernel, sample by sample, so the kernel is exact for any offset.
//
// Bound: memory bytes. x, offset, mask and gout read once, dx, doffset and dmask written once:
// at 16 x 80 x 80 x 64 about 101 MB, 0.030 ms at 3.35 TB/s; the arithmetic, at least 26 FLOP
// per output value and kernel point, takes less at the float32 rate. The direct form (the
// kernel before this design) made 36 float atomic adds into device memory and 36 corner loads
// through L1/L2 per output value, and reached 4-5% of that bound. Here a window element takes
// one add into device memory per chunk, about 5 per output value at a 4 x 4 tile.
//
// Design (dcnv3_common.cuh holds the geometry, the plan and the staging): a block owns one
// image, one group and a tile of output pixels (kernels/dcn_sampling.py:dcnv3_plan), and
// loops over the group's channels in chunks of CC (at most 64).
// 1. It copies the first chunk's window of x into shared memory with cp.async (the zero fill
//    is the zero padding) and, while that flies, computes each pixel's kk samples into shared
//    memory exactly as csrc/dcnv3.cu computes them (the same __fadd_rn/__fmul_rn order and
//    floorf: a corner that differed would put doffset on the other side of it).
// 2. A warp takes one output pixel at a time, each lane two channels (a pair of neighbours
//    where the channel count is even); it reads gout once for the pixel and, for each kernel
//    point, reads the four corners (from the window, or from device memory outside it), adds
//    gout*mask*w_corner into the window's dx with shared-memory atomics (the lanes add to
//    neighbouring channels of one pixel: no two in one bank), or, for a corner outside the
//    window but inside the image, straight into dx in device memory; and sums over its
//    channels four products (see Sums), reduced over the warp by shuffles. Four lanes add
//    them to the pixel's sums: each sum has one owner warp and the chunks come in order, so
//    doffset and dmask are the same bits from run to run.
// 3. At the end of each chunk the next chunk's window of x is copied while the window's dx is
//    flushed into dx in device memory, one atomic add per nonzero element inside the image
//    (neighbouring windows overlap), and zeroed. The order of dx's adds, and so its last
//    bits, changes from run to run: dx is held to 1e-5 of its largest magnitude.
// 4. doffset and dmask follow from each point's four sums and its bilinear weights, times
//    mask x offset_scale for doffset (ds/doffset = offset_scale): one plain store each.
// Measured (torch.profiler's device time, chip_smoke.py --device-times, on an H100 SXM at
// 700 W; PERF.md): the direct form took 0.61 / 0.31 / 0.15 ms at 16 x 80x80x64 / 40x40x128 /
// 20x20x256, this design 0.28 / 0.15 / 0.092, 11% of the byte bound at 80x80x64. Sm_90 has no
// native float add on shared memory: atomicAdd(float) there compiles to a compare-and-swap
// loop (cuobjdump: ATOMS.CAST.SPIN), so a lane adds a channel pair with one 64-bit swap
// (ATOMS.CAS.64), the four corners' swaps in flight together; the flush and the escapes add
// 16 and 8 bytes at once (REDG.E.ADD.F32x4, .F32x2). Small tiles of 4 x 4 with a 1-px margin
// and four blocks an SM (at most 64 registers a thread) measured fastest, on a trained
// model's offsets too, 4-39% of whose samples leave the window (a 2-px margin halves that
// and costs 3-28% more time). What holds it at a tenth of the bound (latency, or
// shared-memory throughput) is not measured: no profiler of the card's counters runs where
// it was timed.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include "dcnv3_common.cuh"

namespace {

using dcnv3::Corners;
using dcnv3::Plan;
using dcnv3::Geometry;
using dcnv3::Sample;

// Four sums over a pixel's channels per kernel point, from which the chunk's doffset and dmask
// follow by the sample's weights alone (step 5): with a = v1 - v0, b = v3 - v2, e = v2 - v0,
//   d(sample)/dsx = a + wy*(b - a),  d(sample)/dsy = e + wx*(b - a),
//   sample = v0 + wx*a + wy*d(sample)/dsy,
// so the sums of gout times each are the same combinations of A = sum(gout*a), B, E and
// Z = sum(gout*v0): 3 subtractions and 4 multiply-adds a channel.
struct Sums {
  float a = 0.0f, b = 0.0f, e = 0.0f, z = 0.0f;
  __device__ __forceinline__ void add(float v0, float v1, float v2, float v3, float go) {
    a = fmaf(go, v1 - v0, a);
    b = fmaf(go, v3 - v2, b);
    e = fmaf(go, v2 - v0, e);
    z = fmaf(go, v0, z);
  }
};

// word's two floats plus (g0, g1) * w
__device__ __forceinline__ unsigned long long add2(unsigned long long word, float g0, float g1,
                                                   float w) {
  const float lo = fmaf(g0, w, __uint_as_float((unsigned)word));
  const float hi = fmaf(g1, w, __uint_as_float((unsigned)(word >> 32)));
  return ((unsigned long long)__float_as_uint(hi) << 32) | __float_as_uint(lo);
}

// Adds (g0, g1) * w to the two floats at addr (8-byte aligned, shared memory). Sm_90 has no native
// float add on shared memory: atomicAdd(float) there is a compare-and-swap loop. One 64-bit
// swap adds two channels, half the loops.
__device__ __forceinline__ void atomic_add2(float* addr, float g0, float g1, float w) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long seen = *p, want;
  do {
    want = seen;
    seen = atomicCAS(p, want, add2(want, g0, g1, w));
  } while (seen != want);
}

// The four corners' pairs at once: four independent reads and swaps in flight, then a retry
// of any swap that lost to another warp (rare: corners of other pixels' samples).
__device__ __forceinline__ void atomic_add2_corners(float* base, const int (&at)[4],
                                                    const float (&w)[4], float g0, float g1) {
  unsigned long long* p[4];
  unsigned long long seen[4], want[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = reinterpret_cast<unsigned long long*>(base + at[c]);
    want[c] = *p[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) seen[c] = atomicCAS(p[c], want[c], add2(want[c], g0, g1, w[c]));
#pragma unroll
  for (int c = 0; c < 4; ++c)
    while (seen[c] != want[c]) {
      want[c] = seen[c];
      seen[c] = atomicCAS(p[c], want[c], add2(want[c], g0, g1, w[c]));
    }
}

// A lane holds two channels of the chunk: with V = 2 the pair (2*lane, 2*lane + 1), read and
// added as one 8-byte word; with V = 1 (an odd channel count) lane and lane + 32.
template <int V>
__device__ __forceinline__ int lane_channel(int lane, int i) {
  return V == 2 ? 2 * lane + i : lane + 32 * i;
}

// at most 64 registers a thread, so four blocks of 256 fit an SM
template <int V>
__global__ void __launch_bounds__(dcnv3::kThreads, 4) dcnv3_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ gout,
    float* __restrict__ dx, float* __restrict__ doffset, float* __restrict__ dmask,
    int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale, Plan pl, int n_tx, int n_ty,
    bool vec, bool flush4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KK = K * K, GK = G * KK;
  const int npix = pl.th * pl.tw;
  const int nwin = pl.wh * pl.ww * pl.cc;
  Geometry geo(smem, npix * KK);
  unsigned char* next = smem + Geometry::bytes((size_t)npix * KK);
  float4* acc = reinterpret_cast<float4*>(next);  // (pixel, point): the four Sums
  next += (size_t)npix * KK * sizeof(float4);
  float* dxw = reinterpret_cast<float*>(next);  // the window's dx
  float* xw = dxw + ((nwin + 3) & ~3);          // the window's x

  long long bid = blockIdx.x;
  const int tx = (int)(bid % n_tx); bid /= n_tx;
  const int ty = (int)(bid % n_ty); bid /= n_ty;
  const int g = (int)(bid % G);
  const long long b = bid / G;
  const int oy0 = ty * pl.th, ox0 = tx * pl.tw;
  const int wy0 = dcnv3::window_row(row0, oy0, stride, pl);
  const int wx0 = ox0 * stride + pl.win_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  const long long img = b * H * W * C + g * GC;
  const int n_chunks = (GC + pl.cc - 1) / pl.cc;
  const int row = pl.ww * pl.cc;  // one window row, in floats
  // 1. the first chunk's window of x, copied while the geometry is computed; its dx zeroed
  dcnv3::stage_window(xw, x + img, 0, min(pl.cc, GC), wy0, wx0, pl, H, W, C, vec);
  for (int e = threadIdx.x; e < (nwin + 3) / 4; e += blockDim.x)
    reinterpret_cast<float4*>(dxw)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // 2. sample geometry of the tile for group g, and the four sums zeroed
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
    acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * pl.cc, ncur = min(pl.cc, GC - c0);
    const float* xc = x + img + c0;
    float* dxc = dx + img + c0;
    dcnv3::cp_async_wait_all();
    __syncthreads();  // the geometry, this chunk's window of x and its zeroed dx in place

    // 3. a warp a pixel, lanes along the channels
    for (int q = warp; q < npix; q += nwarps) {
      const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
      if (oy >= Ho || ox >= Wo) continue;  // uniform across the warp
      const long long pix = (b * Ho + oy) * Wo + ox;
      float go[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ch = lane_channel<V>(lane, i);
        go[i] = ch < ncur ? __ldg(gout + pix * C + g * GC + c0 + ch) : 0.0f;
      }
      float* aq = reinterpret_cast<float*>(acc + q * KK);
      Sample next = geo.load(q * KK);
      for (int p = 0; p < KK; ++p) {
        const Sample s = next;
        if (p + 1 < KK) next = geo.load(q * KK + p + 1);  // in flight while s is added
        const float w[4] = {(1.0f - s.wx) * (1.0f - s.wy), s.wx * (1.0f - s.wy),
                            (1.0f - s.wx) * s.wy, s.wx * s.wy};
        Sums sum;
        if (s.wofs >= 0) {  // fast path: the four corners in the window
          const int at[4] = {s.wofs, s.wofs + pl.cc, s.wofs + row, s.wofs + row + pl.cc};
          if (V == 2) {
            const int ch = 2 * lane;
            if (ch < ncur) {  // ncur is even: both channels
              float2 v[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) v[c] = *reinterpret_cast<const float2*>(xw + at[c] + ch);
              sum.add(v[0].x, v[1].x, v[2].x, v[3].x, go[0]);
              sum.add(v[0].y, v[1].y, v[2].y, v[3].y, go[1]);
              atomic_add2_corners(dxw + ch, at, w, go[0] * s.m, go[1] * s.m);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int ch = lane_channel<V>(lane, i);
              if (ch < ncur) {
                sum.add(xw[at[0] + ch], xw[at[1] + ch], xw[at[2] + ch], xw[at[3] + ch], go[i]);
                const float gm = go[i] * s.m;
#pragma unroll
                for (int c = 0; c < 4; ++c) atomicAdd(dxw + at[c] + ch, gm * w[c]);
              }
            }
          }
        } else {  // a corner outside the window
          const Corners k = dcnv3::locate(geo.corner[q * KK + p], wy0, wx0, pl, H, W);
          if (V == 2) {
            const int ch = 2 * lane;
            if (ch < ncur) {
              float v0[4], v1[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                v0[c] = dcnv3::corner_value(k, c, xw, xc, pl.cc, C, ch);
                v1[c] = dcnv3::corner_value(k, c, xw, xc, pl.cc, C, ch + 1);
              }
              sum.add(v0[0], v0[1], v0[2], v0[3], go[0]);
              sum.add(v1[0], v1[1], v1[2], v1[3], go[1]);
              const float g0 = go[0] * s.m, g1 = go[1] * s.m;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (k.win[c] >= 0)
                  atomic_add2(dxw + k.win[c] * pl.cc + ch, g0, g1, w[c]);
                else if (k.mem[c] >= 0)  // one 8-byte reduction in device memory
                  atomicAdd(reinterpret_cast<float2*>(dxc + (long long)k.mem[c] * C + ch),
                            make_float2(g0 * w[c], g1 * w[c]));
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int ch = lane_channel<V>(lane, i);
              if (ch < ncur) {
                float v[4];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  v[c] = dcnv3::corner_value(k, c, xw, xc, pl.cc, C, ch);
                sum.add(v[0], v[1], v[2], v[3], go[i]);
                const float gm = go[i] * s.m;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  if (k.win[c] >= 0)
                    atomicAdd(dxw + k.win[c] * pl.cc + ch, gm * w[c]);
                  else if (k.mem[c] >= 0)
                    atomicAdd(dxc + (long long)k.mem[c] * C + ch, gm * w[c]);
                }
              }
            }
          }
        }
        // the four sums over the warp in 6 shuffles, in a fixed order: lanes 0, 8, 16 and 24
        // end with A, B, E and Z
        const bool hi16 = lane & 16, hi8 = lane & 8;
        float k0 = hi16 ? sum.e : sum.a, k1 = hi16 ? sum.z : sum.b;
        k0 += __shfl_xor_sync(0xffffffffu, hi16 ? sum.a : sum.e, 16);
        k1 += __shfl_xor_sync(0xffffffffu, hi16 ? sum.b : sum.z, 16);
        float t = hi8 ? k1 : k0;
        t += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if ((lane & 7) == 0) aq[4 * p + (lane >> 3)] += t;
      }
    }
    __syncthreads();

    // 4. the next chunk's window of x, copied while this chunk's dx is flushed into device
    // memory: one add per nonzero element inside the image, four channels at once where they
    // lie 16-byte aligned in dx; each flushed element is zeroed for the next chunk. As in the
    // copy, a thread keeps its channels and steps over the window's pixels.
    if (ci + 1 < n_chunks)
      dcnv3::stage_window(xw, x + img, c0 + pl.cc, min(pl.cc, GC - c0 - pl.cc), wy0, wx0, pl, H,
                          W, C, vec);
    const int width = flush4 ? 4 : 1;
    const int lanes = pl.cc / width, step = blockDim.x / lanes;
    const int c = (threadIdx.x % lanes) * width;
    if ((int)threadIdx.x < step * lanes)
      for (int wp = threadIdx.x / lanes; wp < pl.wh * pl.ww; wp += step) {
        const int wy = wp / pl.ww;
        const int y = wy0 + wy, xx = wx0 + wp - wy * pl.ww;
        const bool in = c < ncur && (unsigned)y < (unsigned)H && (unsigned)xx < (unsigned)W;
        float* w = dxw + wp * pl.cc + c;
        float* d = dxc + ((long long)y * W + xx) * C + c;
        if (flush4) {
          const float4 v = *reinterpret_cast<float4*>(w);
          *reinterpret_cast<float4*>(w) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (in && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
            atomicAdd(reinterpret_cast<float4*>(d), v);
        } else {
          const float v = *w;
          *w = 0.0f;
          if (in && v != 0.0f) atomicAdd(d, v);
        }
      }
  }
  __syncthreads();

  // 5. doffset and dmask, one store each
  for (int e = threadIdx.x; e < npix * KK; e += blockDim.x) {
    const int q = e / KK, p = e % KK;
    const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
    if (oy >= Ho || ox >= Wo) continue;
    const long long pix = (b * Ho + oy) * Wo + ox;
    const int gp = g * KK + p;
    const float4 S = acc[e];  // A, B, E, Z
    const dcnv3::FastSample f = geo.fast[e];
    const float dsx = fmaf(f.wy, S.y - S.x, S.x);
    const float dsy = fmaf(f.wx, S.y - S.x, S.z);
    const float scale = f.m * offset_scale;
    doffset[pix * (2LL * GK) + 2 * gp] = dsx * scale;
    doffset[pix * (2LL * GK) + 2 * gp + 1] = dsy * scale;
    dmask[pix * GK + gp] = fmaf(f.wy, dsy, fmaf(f.wx, S.x, S.w));
  }
}

int allowed_shared[2][64];  // per kernel and device: the most shared memory allowed so far

}  // namespace

extern "C" int dcnv3_backward_launch(
    const void* x, const void* offset, const void* mask, const void* gout,
    void* dx, void* doffset, void* dmask,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale,
    int th, int tw, int cc, int cpb, int win_off, int wh, int ww, void* stream) {
  const Plan pl{th, tw, cc, cpb, win_off, wh, ww};
  int rc = dcnv3::check_call(B, H, W, C, Ho, Wo, G, GC, K, stride, dil, pl, 64);
  if (rc) return rc;
  if (row0 < 0) return (int)cudaErrorInvalidValue;
  if ((long long)cpb * cc < GC) return (int)cudaErrorInvalidValue;  // a block takes every chunk
  const int n_ty = (Ho + th - 1) / th, n_tx = (Wo + tw - 1) / tw;
  const long long blocks = (long long)B * G * n_ty * n_tx;
  const size_t nwin = (size_t)wh * ww * cc;
  const size_t shared = dcnv3::Geometry::bytes((size_t)th * tw * K * K) +
                        (size_t)th * tw * K * K * sizeof(float4) +
                        ((nwin + 3) & ~(size_t)3) * sizeof(float) * 2;
  if ((rc = dcnv3::check_size(blocks, shared))) return rc;
  const bool vec = cc % 4 == 0 && GC % 4 == 0 && ((uintptr_t)x & 15) == 0;
  // channel pairs: every chunk even, so every pair is whole; 8- and 16-byte adds into dx
  const bool pairs = cc % 2 == 0 && GC % 2 == 0 && ((uintptr_t)dx & 7) == 0;
  const bool flush4 = cc % 4 == 0 && GC % 4 == 0 && ((uintptr_t)dx & 15) == 0;
  auto kernel = pairs ? dcnv3_backward_kernel<2> : dcnv3_backward_kernel<1>;
  if ((rc = dcnv3::allow_shared(kernel, shared, allowed_shared[pairs]))) return rc;
  kernel<<<(unsigned)blocks, dcnv3::kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask, (const float*)gout,
      (float*)dx, (float*)doffset, (float*)dmask,
      H, W, C, Ho, Wo, G, GC, K, stride, pad, dil, row0, offset_scale, pl, n_tx, n_ty, vec,
      flush4);
  return (int)cudaGetLastError();
}

extern "C" const char* dcnv3_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
