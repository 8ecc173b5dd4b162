// DCNv3 sampling backward, channels-last: given x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK) and the output gradient
// gout (B, Ho, Wo, C), all float32 or all bfloat16, writes dx (B, H, W, C), doffset
// (B, Ho, Wo, G*KK*2) and dmask (B, Ho, Wo, G*KK), each in its input's type
// (dcnv3_common.cuh: float32 arithmetic, each output rounded once at its store).
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_bwd
// (pallas_call at :437). That kernel keeps a band of input rows in VMEM, gathers the corner
// values as one-hot matmuls over it and scatters dx as their transpose into the band, which
// its sequential grid revisits row by row, in order: every run gives the same bits. Here the
// band becomes a window of the input in shared memory, one per block; a corner outside the
// window is handled inside the kernel, sample by sample, so the kernel is exact for any
// offset. Its blocks run in parallel, in no order, and it too gives the same bits on every
// run, for any offsets and any row0: no float add depends on which block or warp comes first.
//
// - doffset and dmask: each of a sample's four sums over the group's channels has one owner
//   warp, which adds the chunks in order; a warp's lanes are reduced by shuffles in a fixed
//   pattern.
// - dx is a sum of terms gout*mask*w, one for each sample corner that lands on the pixel,
//   from any block. Inside a block, one warp sums a window pixel's terms in float32, in the
//   order of the tile's samples. Across blocks dx is summed in fixed point: every term, or a
//   block's float32 sum of terms, counts as an integer multiple of u = 2^(E + bits - 61), rounded to nearest, where
//   2^E bounds every term (from max |gout| and max |mask| of the call) and 2^bits the samples
//   of one image and group, so no sum reaches 2^62 u. Integers add associatively: 64-bit
//   integer reductions in device memory give the same sum in any order, and dx is that sum
//   times u, rounded once to x's type. A term below u/2 (2^-45 of the largest at 80 x 80)
//   counts 0; every other is summed exactly, so dx is closer to the exact sum than a float32
//   sum in any order.
// - gout or mask with a NaN or an infinity: dx is NaN everywhere (JAX's one-hot products
//   spread such a value over the band as well).
//
// Bound: memory bytes. x, offset, mask and gout read once, dx, doffset and dmask written once:
// at 16 x 80 x 80 x 64 in float32 about 101 MB, 0.030 ms at 3.35 TB/s; in bfloat16 about
// three quarters (offset and mask stay small, gout and x halve). The arithmetic, at least 26
// FLOP per output value and kernel point, takes less at the float32 rate. The fixed point
// adds its own traffic: 8 bytes of integer sum an element of dx, zeroed, reduced into and
// read back, and a reduction a nonzero window element.
//
// Three kernels, launched in order on the caller's stream:
// 0. dcnv3_backward_kernel_prep zeroes the integer sums (one int64 an element of dx); each of
//    its blocks writes max |gout| and max |mask| over its part (the first NaN where a value
//    of either is not finite).
// 1. dcnv3_backward_kernel: a block owns one image, one group and a tile of output pixels
//    (kernels/dcn_sampling.py:dcnv3_plan) and loops over the group's channels in chunks of CC
//    (at most 64).
//    a. It copies the first chunk's window of x into shared memory with cp.async (the zero
//       fill is the zero padding) and, while that flies, reduces the parts' maxima to the
//       scale, computes each pixel's kk samples exactly as csrc/dcnv3.cu computes them (the
//       same __fadd_rn/__fmul_rn order and floorf: a corner that differed would put doffset
//       on the other side of it), and lists the samples by the cell of their top-left corner
//       (the window and one row and column more on the top and left): counted, scanned, and
//       placed in their order by one warp, 32 at a time, so each list is in sample order.
//    b. For each chunk it stages the tile's gout in float32. A warp takes one output pixel at
//       a time, each lane two channels (a pair of neighbours where the channel count is
//       even); for each kernel point it reads the four corners (from the window, or from
//       device memory outside it) and sums over its channels four products (see Sums),
//       reduced over the warp by shuffles into the pixel's sums. A corner outside the window
//       but inside the image adds its term gout * (mask * w), in fixed point, straight into
//       dx's sums.
//    c. Then a warp takes one window pixel inside the image at a time, lanes along the
//       channels, and sums the terms gout * (mask * w) of its corners in float32 (each
//       sample's four products mask * w made once, in a): corner by corner, the samples of
//       the cell that puts that corner on the pixel, in their order (no atomics in shared
//       memory); each sum, in fixed point, goes into dx's sums with one 64-bit reduction, the
//       lanes on neighbouring channels.
//    d. doffset and dmask follow from each point's four sums and its bilinear weights, times
//       mask x offset_scale for doffset (ds/doffset = offset_scale): one store each.
// 2. dcnv3_backward_kernel_dx writes dx from the integer sums.
// The window's float32 sums depend on the inputs and the plan alone, the plan on the shapes
// alone, and the integer sums on no order, so two runs give the same bits. A bfloat16 call
// takes the float32 call's plan (kernels/dcn_sampling.py:dcnv3_plan): its outputs are the
// float32 call's on float32 copies, rounded.
// Measured (torch.profiler's device time of the three kernels, chip_smoke.py --device-times,
// on an H100 SXM at 700 W; PERF.md): 0.505 / 0.247 / 0.148 ms at 16 x 80x80x64 / 40x40x128 /
// 20x20x256, 6% of the byte bound at 80x80x64, against 0.28 / 0.148 / 0.092 for the window
// design with float atomics in shared and device memory that this one replaced. In bfloat16
// it takes 1.0-1.2x the float32 time.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include <algorithm>

#include "dcnv3_common.cuh"

namespace {

using dcnv3::Corners;
using dcnv3::Plan;
using dcnv3::Geometry;
using dcnv3::Sample;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxFloat = 3.40282347e+38f;
constexpr int kStaticShared = 256;  // each kernel's static shared memory: the scale, at most
constexpr int kDxBlocks = 132 * 8;  // the dx pass's blocks at most: 8 an SM

// Four sums over a pixel's channels per kernel point, from which the chunk's doffset and dmask
// follow by the sample's weights alone (step d): with a = v1 - v0, b = v3 - v2, e = v2 - v0,
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

// dx's fixed point: a value v counts as the integer nearest v * 2^k; 2^k = s1 * s2 and
// 2^-k = r1 * r2, each factor a normal float.
struct Scale {
  float s1, s2, r1, r2;
  int bad;  // gout or mask holds a NaN or an infinity: dx is NaN
};

__device__ __forceinline__ float exp2i(int e) {  // 2^e, e in [-126, 127]
  return __uint_as_float((unsigned)(e + 127) << 23);
}

// The block's largest g and m, and whether any thread's `bad` is set, in thread 0: shuffles
// within each warp, then thread 0 over the warps. Ends with every thread past a __syncthreads.
__device__ void block_max(float& g, float& m, int& bad) {
  __shared__ float gmax[dcnv3::kThreads / 32], mmax[dcnv3::kThreads / 32];
  __shared__ int nonfinite[dcnv3::kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    g = fmaxf(g, __shfl_xor_sync(kFull, g, o));
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    bad |= __shfl_xor_sync(kFull, bad, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    gmax[warp] = g;
    mmax[warp] = m;
    nonfinite[warp] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      g = fmaxf(g, gmax[w]);
      m = fmaxf(m, mmax[w]);
      bad |= nonfinite[w];
    }
}

// The call's scale from the prep kernel's maxima of its `nparts` parts, reduced by every block
// alike; `bits`: 2^bits bounds the terms of one element of dx. Ends with __syncthreads.
__device__ void block_scale(const float* __restrict__ part, int nparts, int bits, Scale* out) {
  float g = 0.0f, m = 0.0f;
  int bad = 0;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    bad |= part[2 * i] != part[2 * i];  // a part's NaN marks a value that is not finite
    g = fmaxf(g, part[2 * i]);
    m = fmaxf(m, part[2 * i + 1]);
  }
  block_max(g, m, bad);
  if (threadIdx.x == 0) {
    // every term |gout * mask * w| < 2^(eg + em); in units of 2^-k below 2^(61 - bits)
    int eg = 0, em = 0;
    if (g > 0.0f) frexpf(g, &eg);
    if (m > 0.0f) frexpf(m, &em);
    const int k = 61 - bits - eg - em;
    const int k1 = max(-126, min(126, k)), k2 = max(-126, min(126, k - k1));
    *out = Scale{exp2i(k1), exp2i(k2), exp2i(-k1), exp2i(-k2), bad};
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long to_fixed(float v, const Scale& s) {
  return (unsigned long long)__float2ll_rn(__fmul_rn(__fmul_rn(v, s.s1), s.s2));
}

__device__ __forceinline__ float from_fixed(long long a, const Scale& s) {
  return __fmul_rn(__fmul_rn(__ll2float_rn(a), s.r1), s.r2);
}

// A lane holds two channels of the chunk: with V = 2 the pair (2*lane, 2*lane + 1), read as
// one word; with V = 1 (an odd channel count) lane and lane + 32.
template <int V>
__device__ __forceinline__ int lane_channel(int lane, int i) {
  return V == 2 ? 2 * lane + i : lane + 32 * i;
}

// Adds the lanes' two values t of one pixel (px: dx's sums at the pixel and the chunk's first
// channel) in fixed point, one 64-bit reduction a nonzero value. With V = 2 the values move
// first by shuffles to channels lane and lane + 32, so each reduction covers 32 neighbouring
// channels. Every lane of the warp calls it.
template <int V>
__device__ __forceinline__ void add_fixed(long long* px, float (&t)[2], int lane, int ncur,
                                          const Scale& s) {
  if (V == 2) {
    const float a0 = __shfl_sync(kFull, t[0], lane >> 1), a1 = __shfl_sync(kFull, t[1], lane >> 1);
    const float b0 = __shfl_sync(kFull, t[0], 16 + (lane >> 1));
    const float b1 = __shfl_sync(kFull, t[1], 16 + (lane >> 1));
    t[0] = lane & 1 ? a1 : a0;
    t[1] = lane & 1 ? b1 : b0;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = lane + 32 * j;
    if (ch < ncur && t[j] != 0.0f)
      atomicAdd(reinterpret_cast<unsigned long long*>(px + ch), to_fixed(t[j], s));
  }
}

// max |v| over this thread's share of v's n elements, 16-byte words where v is aligned to them
// (four loads in flight); a value that is not finite sets `bad` instead.
template <typename T>
__device__ __forceinline__ void part_max(const T* __restrict__ v, long long n, float& mx,
                                         int& bad) {
  constexpr int per = 16 / (int)sizeof(T);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const long long nw = ((uintptr_t)v & 15) ? 0 : n / per;
  const uint4* w = reinterpret_cast<const uint4*>(v);
  auto take = [&](float f) {
    const float a = fabsf(f);
    if (a <= kMaxFloat) mx = fmaxf(mx, a);
    else bad = 1;
  };
  auto take_word = [&](const uint4& u) {
    const unsigned b[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        take(__uint_as_float(b[j]));
      } else {
        take(__uint_as_float(b[j] << 16));
        take(__uint_as_float(b[j] & 0xffff0000u));
      }
    }
  };
  long long i = tid;
  for (; i + 3 * nth < nw; i += 4 * nth) {
    const uint4 a = __ldg(w + i), b = __ldg(w + i + nth), c = __ldg(w + i + 2 * nth),
                d = __ldg(w + i + 3 * nth);
    take_word(a);
    take_word(b);
    take_word(c);
    take_word(d);
  }
  for (; i < nw; i += nth) take_word(__ldg(w + i));
  for (long long j = nw * per + tid; j < n; j += nth) take(dcnv3::load_ro(v + j));
}

template <typename T>
__global__ void __launch_bounds__(dcnv3::kThreads) dcnv3_backward_kernel_prep(
    const T* __restrict__ gout, long long n_gout, const T* __restrict__ mask, long long n_mask,
    long long* __restrict__ sums, long long n_sums, float* __restrict__ part) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  longlong2* z = reinterpret_cast<longlong2*>(sums);
  for (long long i = tid; i < n_sums / 2; i += nth) z[i] = make_longlong2(0, 0);
  if (tid == 0 && (n_sums & 1)) sums[n_sums - 1] = 0;
  float g = 0.0f, m = 0.0f;
  int bad = 0;
  part_max(gout, n_gout, g, bad);
  part_max(mask, n_mask, m, bad);
  block_max(g, m, bad);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = bad ? __int_as_float(0x7fc00000) : g;
    part[2 * blockIdx.x + 1] = m;
  }
}

// at most 64 registers a thread, so four blocks of 256 fit an SM
template <int V, typename T>
__global__ void __launch_bounds__(dcnv3::kThreads, 4) dcnv3_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ offset, const T* __restrict__ mask,
    const T* __restrict__ gout, long long* __restrict__ sums, T* __restrict__ doffset,
    T* __restrict__ dmask, const float* __restrict__ part, int nparts, int bits,
    int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale, Plan pl, int n_tx, int n_ty,
    bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scale scale;
  const int KK = K * K, GK = G * KK;
  const int npix = pl.th * pl.tw, nsamp = npix * KK, nwp = pl.wh * pl.ww;
  const int ncell = (pl.wh + 1) * (pl.ww + 1);  // the cells of the samples' top-left corners
  Geometry geo(smem, nsamp);
  unsigned char* next = smem + Geometry::bytes((size_t)nsamp);
  float4* acc = reinterpret_cast<float4*>(next);  // (pixel, point): the four Sums
  next += (size_t)nsamp * sizeof(float4);
  float* mw = reinterpret_cast<float*>(next);  // (pixel, point, corner): mask * weight
  next += (size_t)nsamp * sizeof(float4);
  T* xw = reinterpret_cast<T*>(next);  // the window's x
  next += dcnv3::align16((size_t)nwp * pl.cc * sizeof(T));
  float* gs = reinterpret_cast<float*>(next);  // the tile's gout at this chunk, float32
  next += (size_t)npix * pl.cc * sizeof(float);
  int* items = reinterpret_cast<int*>(next);  // the samples by cell, q << 16 | p
  int* start = items + nsamp;                 // ncell + 1: each cell's first sample
  int* fill = start + ncell + 1;              // ncell: the counts, then the next free places

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
  const int row = pl.ww * pl.cc;  // one window row, in elements
  // a. the first chunk's window of x, copied while the scale, the geometry and the lists are
  // made. A sample's cell is its top-left corner's place in the window, one row and column
  // more on the top and left: (yy + 1, xx + 1) for yy in [-1, wh) and xx in [-1, ww), where
  // at least one of its corners lies in the window; else it has none (-1).
  dcnv3::stage_window(xw, x + img, 0, min(pl.cc, GC), wy0, wx0, pl, H, W, C, vec);
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) fill[i] = 0;
  block_scale(part, nparts, bits, &scale);
  auto cell = [&](int2 yx) {
    const int yy = yx.x - wy0 + 1, xx = yx.y - wx0 + 1;
    return (unsigned)yy <= (unsigned)pl.wh && (unsigned)xx <= (unsigned)pl.ww
               ? yy * (pl.ww + 1) + xx : -1;
  };
  for (int e = threadIdx.x; e < nsamp; e += blockDim.x) {
    const int q = e / KK, p = e % KK;
    const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
    Sample s = dcnv3::empty_sample();
    if (oy < Ho && ox < Wo) {
      s = dcnv3::make_sample(offset, mask, (b * Ho + oy) * Wo + ox, g * KK + p, GK, K,
                             row0 + oy, ox, H, W, stride, pad, dil, offset_scale);
      dcnv3::place(s, wy0, wx0, pl);
      const int k = cell(make_int2(s.y0, s.x0));
      if (k >= 0) atomicAdd(fill + k, 1);
    }
    geo.store(e, s);
    acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(mw)[e] =
        make_float4(s.m * ((1.0f - s.wx) * (1.0f - s.wy)), s.m * (s.wx * (1.0f - s.wy)),
                    s.m * ((1.0f - s.wx) * s.wy), s.m * (s.wx * s.wy));
  }
  __syncthreads();
  if (warp == 0) {
    // the counts' exclusive scan, 32 cells a step
    int carry = 0;
    for (int base = 0; base < ncell; base += 32) {
      const int i = base + lane;
      const int v = i < ncell ? fill[i] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (i < ncell) start[i] = fill[i] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) start[ncell] = carry;
    __syncwarp();
    // the samples placed in their order, 32 at a time: a lane's place is its cell's next free
    // one plus the lanes before it of the same cell
    for (int base = 0; base < nsamp; base += 32) {
      const int e = base + lane;
      const int q = e / KK;
      const int k = e < nsamp && oy0 + q / pl.tw < Ho && ox0 + q % pl.tw < Wo
                        ? cell(geo.corner[e]) : -1;
      const unsigned peers = __match_any_sync(kFull, k);
      const int rank = __popc(peers & ((1u << lane) - 1));
      if (k >= 0) items[fill[k] + rank] = q << 16 | (e - q * KK);
      __syncwarp();
      if (k >= 0 && rank == 0) fill[k] += __popc(peers);
      __syncwarp();
    }
  }
  const Scale sc = scale;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * pl.cc, ncur = min(pl.cc, GC - c0);
    const T* xc = x + img + c0;
    long long* dxc = sums + img + c0;
    for (int i = threadIdx.x; i < npix * pl.cc; i += blockDim.x) {  // the tile's gout
      const int q = i / pl.cc, ch = i - q * pl.cc;
      const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
      gs[i] = oy < Ho && ox < Wo && ch < ncur
                  ? dcnv3::load_ro(gout + ((b * Ho + oy) * Wo + ox) * C + g * GC + c0 + ch)
                  : 0.0f;
    }
    dcnv3::cp_async_wait_all();
    __syncthreads();  // the geometry, this chunk's window of x and its gout in place

    // b. a warp an output pixel, lanes along the channels
    for (int q = warp; q < npix; q += nwarps) {
      const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
      if (oy >= Ho || ox >= Wo) continue;  // uniform across the warp
      float go[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ch = lane_channel<V>(lane, i);
        go[i] = ch < ncur ? gs[q * pl.cc + ch] : 0.0f;
      }
      float* aq = reinterpret_cast<float*>(acc + q * KK);
      Sample next = geo.load(q * KK);
      for (int p = 0; p < KK; ++p) {
        const Sample s = next;
        if (p + 1 < KK) next = geo.load(q * KK + p + 1);  // in flight while s is summed
        Sums sum;
        if (s.wofs >= 0) {  // fast path: the four corners in the window
          const int at[4] = {s.wofs, s.wofs + pl.cc, s.wofs + row, s.wofs + row + pl.cc};
          if (V == 2) {
            const int ch = 2 * lane;
            if (ch < ncur) {  // ncur is even: both channels
              float v[4][2];
#pragma unroll
              for (int c = 0; c < 4; ++c) dcnv3::load_vec<2>(v[c], xw + at[c] + ch);
              sum.add(v[0][0], v[1][0], v[2][0], v[3][0], go[0]);
              sum.add(v[0][1], v[1][1], v[2][1], v[3][1], go[1]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int ch = lane_channel<V>(lane, i);
              if (ch < ncur)
                sum.add(dcnv3::to_float(xw[at[0] + ch]), dcnv3::to_float(xw[at[1] + ch]),
                        dcnv3::to_float(xw[at[2] + ch]), dcnv3::to_float(xw[at[3] + ch]), go[i]);
            }
          }
        } else {  // a corner outside the window
          const Corners k = dcnv3::locate(geo.corner[q * KK + p], wy0, wx0, pl, H, W);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ch = lane_channel<V>(lane, i);
            if (ch < ncur) {
              float v[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) v[c] = dcnv3::corner_value(k, c, xw, xc, pl.cc, C, ch);
              sum.add(v[0], v[1], v[2], v[3], go[i]);
            }
          }
          if (!sc.bad) {
            const float* w = mw + (q * KK + p) * 4;  // mask * weight of each corner
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (k.win[c] < 0 && k.mem[c] >= 0) {  // uniform: one sample a warp
                float t[2] = {go[0] * w[c], go[1] * w[c]};
                add_fixed<V>(dxc + (long long)k.mem[c] * C, t, lane, ncur, sc);
              }
            }
          }
        }
        // the four sums over the warp in 6 shuffles, in a fixed order: lanes 0, 8, 16 and 24
        // end with A, B, E and Z
        const bool hi16 = lane & 16, hi8 = lane & 8;
        float k0 = hi16 ? sum.e : sum.a, k1 = hi16 ? sum.z : sum.b;
        k0 += __shfl_xor_sync(kFull, hi16 ? sum.a : sum.e, 16);
        k1 += __shfl_xor_sync(kFull, hi16 ? sum.b : sum.z, 16);
        float t = hi8 ? k1 : k0;
        t += __shfl_xor_sync(kFull, hi8 ? k0 : k1, 8);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
        if ((lane & 7) == 0) aq[4 * p + (lane >> 3)] += t;
      }
    }

    // c. a warp a window pixel inside the image, lanes along the channels: the terms of the
    // samples with a corner there, corner by corner (the cells up and to the left), each
    // cell's samples in their order, summed in float32; then one fixed-point add a channel
    if (!sc.bad) {
      for (int wp = warp; wp < nwp; wp += nwarps) {
        const int wy = wp / pl.ww, wx = wp - wy * pl.ww;
        const int y = wy0 + wy, xx = wx0 + wx;
        if ((unsigned)y >= (unsigned)H || (unsigned)xx >= (unsigned)W) continue;  // uniform
        float a[2] = {0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = (wy + 1 - (c >> 1)) * (pl.ww + 1) + wx + 1 - (c & 1);
          for (int i = start[k], i1 = start[k + 1]; i < i1; ++i) {
            const int t = items[i];
            const int q = t >> 16;
            const float w = mw[(q * KK + (t & 0xffff)) * 4 + c];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int ch = lane_channel<V>(lane, j);
              if (ch < ncur) a[j] = fmaf(gs[q * pl.cc + ch], w, a[j]);
            }
          }
        }
        add_fixed<V>(dxc + ((long long)y * W + xx) * C, a, lane, ncur, sc);
      }
    }
    __syncthreads();

    // the next chunk's window of x
    if (ci + 1 < n_chunks)
      dcnv3::stage_window(xw, x + img, c0 + pl.cc, min(pl.cc, GC - c0 - pl.cc), wy0, wx0, pl, H,
                          W, C, vec);
  }

  // d. doffset and dmask, one store each
  for (int e = threadIdx.x; e < nsamp; e += blockDim.x) {
    const int q = e / KK, p = e % KK;
    const int oy = oy0 + q / pl.tw, ox = ox0 + q % pl.tw;
    if (oy >= Ho || ox >= Wo) continue;
    const long long pix = (b * Ho + oy) * Wo + ox;
    const int gp = g * KK + p;
    const float4 S = acc[e];  // A, B, E, Z
    const dcnv3::FastSample f = geo.fast[e];
    const float dsx = fmaf(f.wy, S.y - S.x, S.x);
    const float dsy = fmaf(f.wx, S.y - S.x, S.z);
    const float scale_m = f.m * offset_scale;
    doffset[pix * (2LL * GK) + 2 * gp] = dcnv3::from_float<T>(dsx * scale_m);
    doffset[pix * (2LL * GK) + 2 * gp + 1] = dcnv3::from_float<T>(dsy * scale_m);
    dmask[pix * GK + gp] = dcnv3::from_float<T>(fmaf(f.wy, dsy, fmaf(f.wx, S.x, S.w)));
  }
}

// dx = the integer sums times u, in T; NaN everywhere where the scale is bad.
template <typename T>
__global__ void __launch_bounds__(dcnv3::kThreads) dcnv3_backward_kernel_dx(
    const long long* __restrict__ sums, T* __restrict__ dx, long long n,
    const float* __restrict__ part, int nparts, int bits) {
  __shared__ Scale scale;
  block_scale(part, nparts, bits, &scale);
  const Scale s = scale;
  const float nan = __int_as_float(0x7fc00000);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const longlong2* in = reinterpret_cast<const longlong2*>(sums);
  for (long long i = tid; i < n / 2; i += nth) {
    const longlong2 a = in[i];
    const float d[2] = {s.bad ? nan : from_fixed(a.x, s), s.bad ? nan : from_fixed(a.y, s)};
    dcnv3::store_vec<2>(dx + 2 * i, d);
  }
  if (tid == 0 && (n & 1)) dx[n - 1] = dcnv3::from_float<T>(s.bad ? nan : from_fixed(sums[n - 1], s));
}

// Dynamic shared memory of a block of the main kernel (kernels/dcn_sampling.py:dcnv3_shared_bytes).
inline size_t shared_bytes(const Plan& pl, int kk, int es) {
  const size_t n = (size_t)pl.th * pl.tw * kk, nwp = (size_t)pl.wh * pl.ww;
  const size_t ncell = (size_t)(pl.wh + 1) * (pl.ww + 1);
  return Geometry::bytes(n) + 2 * n * sizeof(float4) + dcnv3::align16(nwp * pl.cc * es) +
         (size_t)pl.th * pl.tw * pl.cc * sizeof(float) + (n + 2 * ncell + 1) * sizeof(int);
}

int allowed_shared[4][64];  // per kernel and device: the most shared memory allowed so far

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* gout, void* dx,
           void* doffset, void* dmask, void* sums, void* part, int nparts, int B, int H, int W,
           int C, int Ho, int Wo, int G, int GC, int K, int stride, int pad, int dil, int row0,
           float offset_scale, const Plan& pl, cudaStream_t stream) {
  constexpr int es = (int)sizeof(T);
  const int n_ty = (Ho + pl.th - 1) / pl.th, n_tx = (Wo + pl.tw - 1) / pl.tw;
  const long long blocks = (long long)B * G * n_ty * n_tx;
  const size_t shared = shared_bytes(pl, K * K, es);
  int rc = dcnv3::check_size(blocks, shared + kStaticShared);
  if (rc) return rc;
  const long long n_dx = (long long)B * H * W * C, n_gout = (long long)B * Ho * Wo * C;
  const long long n_mask = (long long)B * Ho * Wo * G * K * K;
  int bits = 1;  // 2^bits bounds the samples of one image and group
  while ((1LL << bits) < (long long)Ho * Wo * K * K) ++bits;
  const bool vec = dcnv3::vec_staging<T>(pl.cc, GC, x);
  const bool pairs = pl.cc % 2 == 0 && GC % 2 == 0;  // every chunk even, so every pair whole
  auto kernel = pairs ? dcnv3_backward_kernel<2, T> : dcnv3_backward_kernel<1, T>;
  if ((rc = dcnv3::allow_shared(kernel, shared, allowed_shared[pairs + 2 * (es == 2)])))
    return rc;
  dcnv3_backward_kernel_prep<T><<<nparts, dcnv3::kThreads, 0, stream>>>(
      (const T*)gout, n_gout, (const T*)mask, n_mask, (long long*)sums, n_dx, (float*)part);
  if ((rc = (int)cudaGetLastError())) return rc;
  kernel<<<(unsigned)blocks, dcnv3::kThreads, shared, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)gout, (long long*)sums,
      (T*)doffset, (T*)dmask, (const float*)part, nparts, bits, H, W, C, Ho, Wo, G, GC, K,
      stride, pad, dil, row0, offset_scale, pl, n_tx, n_ty, vec);
  if ((rc = (int)cudaGetLastError())) return rc;
  const long long dx_blocks = std::max(
      1LL, std::min((long long)kDxBlocks, (n_dx / 2 + dcnv3::kThreads - 1) / dcnv3::kThreads));
  dcnv3_backward_kernel_dx<T><<<(unsigned)dx_blocks, dcnv3::kThreads, 0, stream>>>(
      (const long long*)sums, (T*)dx, n_dx, (const float*)part, nparts, bits);
  return (int)cudaGetLastError();
}

}  // namespace

// sums: B*H*W*C int64, part: 2*nparts float32, both scratch of the wrapper; nparts: the prep
// kernel's blocks.
extern "C" int dcnv3_backward_launch(
    const void* x, const void* offset, const void* mask, const void* gout,
    void* dx, void* doffset, void* dmask, void* sums, void* part,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, int row0, float offset_scale,
    int th, int tw, int cc, int cpb, int win_off, int wh, int ww, int dtype, int nparts,
    void* stream) {
  const Plan pl{th, tw, cc, cpb, win_off, wh, ww};
  const int rc = dcnv3::check_call(B, H, W, C, Ho, Wo, G, GC, K, stride, dil, row0, pl, 64,
                                   dtype);
  if (rc) return rc;
  if ((long long)cpb * cc < GC) return (int)cudaErrorInvalidValue;  // a block takes every chunk
  // the samples' packing in the lists: q << 16 | p
  if (K * K > 65535 || th * tw > 32767 || nparts <= 0) return (int)cudaErrorInvalidValue;
  auto fn = dtype == dcnv3::kBFloat16 ? launch<dcnv3::bf16> : launch<float>;
  return fn(x, offset, mask, gout, dx, doffset, dmask, sums, part, nparts, B, H, W, C, Ho, Wo,
            G, GC, K, stride, pad, dil, row0, offset_scale, pl, (cudaStream_t)stream);
}

extern "C" const char* dcnv3_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
