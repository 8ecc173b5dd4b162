// What the DCNv3 forward (dcnv3.cu) and backward (dcnv3_bwd.cu) kernels share: the sample
// geometry, which both must compute bit for bit alike (or the backward's doffset lands on the
// other side of a corner from the forward's sample), the launch plan and its window of the
// input in shared memory, the staging of that window with cp.async, and the host-side checks.
//
// Layout, as everywhere in the port: float32, channels-last, x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK), kernel points X-major
// (p = ix*K + iy), coordinates those of yolo_dual_tpu/nn/dcn.py:dcnv3_coords.
//
// Output row oy of a call is global row row0 + oy: a space rank of a 2-D mesh
// (parallel/spatial.py) samples its band of output rows, from its band's offsets and mask, in
// the whole gathered x; row0 = 0 on a whole map.
//
// The plan (chosen on the host by kernels/dcn_sampling.py:dcnv3_plan): a block owns one
// image, one group and a tile of TH x TW output pixels. Its window is the rows
// [(row0 + ty0)*stride + win_off, + wh) and the columns [tx0*stride + win_off, + ww) of the
// unpadded input: the tile's zero-offset footprint, the bilinear +1 corner and a margin on
// every side.
// x is staged in the window, one chunk of channels at a time. The window only decides where a
// corner is read (and, in the backward, where its gradient is added first); a corner outside
// it is read from device memory, so any offset is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dcnv3 {

constexpr int kThreads = 256;           // 8 warps a block
constexpr int kMaxShared = 232448;      // 227 KB, what one block of sm_90 may take

struct Plan {
  int th, tw;     // output tile
  int cc;         // channels a chunk: at most 32 times a kernel's channels a lane
  int cpb;        // chunks a block (the forward may split a group's chunks over blocks)
  int win_off;    // window origin minus the tile origin times the stride, rows and columns
  int wh, ww;     // window rows and columns
};

struct Sample {
  int y0, x0;     // top-left corner in unpadded input pixels, clamped to [-2, H] x [-2, W]
  int wofs;       // (window pixel of the top-left corner) * cc when all four corners lie in
                  // the window, else -1: the fast path
  float wx, wy;   // bilinear fractions
  float m;        // mask weight; 0 for a tile pixel outside the output
};

// In shared memory a sample is two records: what the fast path reads, one 16-byte load, and
// the corner, which only the slow path reads.
struct __align__(16) FastSample {
  float wx, wy, m;
  int wofs;
};

struct Geometry {
  FastSample* fast;  // one a (pixel, point) of the tile
  int2* corner;      // (y0, x0)
  __host__ __device__ static size_t bytes(size_t n) {
    return n * sizeof(FastSample) + ((n * sizeof(int2) + 15) & ~(size_t)15);
  }
  __device__ Geometry(unsigned char* smem, int n)
      : fast(reinterpret_cast<FastSample*>(smem)),
        corner(reinterpret_cast<int2*>(smem + (size_t)n * sizeof(FastSample))) {}
  __device__ void store(int e, const Sample& s) {
    fast[e] = FastSample{s.wx, s.wy, s.m, s.wofs};
    corner[e] = make_int2(s.y0, s.x0);
  }
  // the fast fields (y0 and x0 stay in `corner`)
  __device__ Sample load(int e) const {
    const FastSample f = fast[e];
    Sample s;
    s.wx = f.wx; s.wy = f.wy; s.m = f.m; s.wofs = f.wofs;
    s.y0 = s.x0 = 0;
    return s;
  }
};

// The first input row of the window of a tile whose first output row is oy0.
__device__ __forceinline__ int window_row(int row0, int oy0, int stride, const Plan& pl) {
  return (row0 + oy0) * stride + pl.win_off;
}

// The sample of output pixel (oy, ox) of image b at kernel point gp = g*KK + p, oy the global
// row (row0 + the call's row) and pix the pixel's index in offset and mask: the plain
// version's order of operations, without contraction into FMAs, and floorf (floor(-0.5) is
// -1). The corner is clamped as a float before it becomes an int, so no offset overflows it:
// below -1 both of its rows (columns) lie outside and stay so at -2, at H or above likewise.
__device__ __forceinline__ Sample make_sample(
    const float* __restrict__ offset, const float* __restrict__ mask, long long pix, int gp,
    int GK, int K, int oy, int ox, int H, int W, int stride, int pad, int dil,
    float offset_scale) {
  const int half = (dil * (K - 1)) / 2;
  const int p = gp % (K * K);
  const float gx = (float)(-half + (p / K) * dil);
  const float gy = (float)(-half + (p % K) * dil);
  const float* off = offset + pix * (2LL * GK) + 2 * gp;
  const float bx = (float)(ox * stride + half) + 0.5f;
  const float by = (float)(oy * stride + half) + 0.5f;
  const float sx = __fsub_rn(__fadd_rn(bx, __fmul_rn(offset_scale, __fadd_rn(gx, off[0]))), 0.5f);
  const float sy = __fsub_rn(__fadd_rn(by, __fmul_rn(offset_scale, __fadd_rn(gy, off[1]))), 0.5f);
  const float x0 = floorf(sx), y0 = floorf(sy);
  Sample s;
  s.wx = sx - x0;
  s.wy = sy - y0;
  s.m = mask[pix * GK + gp];
  s.y0 = (int)fminf(fmaxf(y0 - (float)pad, -2.0f), (float)H);
  s.x0 = (int)fminf(fmaxf(x0 - (float)pad, -2.0f), (float)W);
  s.wofs = -1;
  return s;
}

__device__ __forceinline__ Sample empty_sample() {
  Sample s;
  s.y0 = s.x0 = -2;
  s.wofs = -1;
  s.wx = s.wy = s.m = 0.0f;
  return s;
}

// The tile's window origin (wy0, wx0) places the sample: with its four corners in the
// window, the kernels take the fast path, four reads (and adds) at fixed strides.
__device__ __forceinline__ void place(Sample& s, int wy0, int wx0, const Plan& pl) {
  const int yy = s.y0 - wy0, xx = s.x0 - wx0;
  if (yy >= 0 && xx >= 0 && yy + 1 < pl.wh && xx + 1 < pl.ww)
    s.wofs = (yy * pl.ww + xx) * pl.cc;
}

// Where the four corners of a sample are, (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1):
// win[c] is the corner's pixel in the window (-1 outside it), mem[c] its pixel y*W + x in
// the image (-1 outside the image). A corner in the window and outside the image reads the
// window's zero fill and its gradient is never flushed.
struct Corners {
  int win[4];
  int mem[4];
};

__device__ __forceinline__ Corners locate(int2 yx, int wy0, int wx0, const Plan& pl, int H,
                                          int W) {
  Corners k;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int y = yx.x + (c >> 1), x = yx.y + (c & 1);
    const int yy = y - wy0, xx = x - wx0;
    k.win[c] = (unsigned)yy < (unsigned)pl.wh && (unsigned)xx < (unsigned)pl.ww
                   ? yy * pl.ww + xx : -1;
    k.mem[c] = (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W ? y * W + x : -1;
  }
  return k;
}

// Corner c of x at channel ch of the chunk: from the window when the corner lies in it, else
// from memory (xc: the image's group at the chunk's first channel), else 0. Every lane of a
// warp holds the same sample, so the branches are uniform.
__device__ __forceinline__ float corner_value(const Corners& k, int c, const float* win,
                                              const float* __restrict__ xc, int cc, int C,
                                              int ch) {
  if (k.win[c] >= 0) return win[k.win[c] * cc + ch];
  return k.mem[c] >= 0 ? __ldg(xc + (long long)k.mem[c] * C + ch) : 0.0f;
}

// The bilinear sample from its four corners, in the plain version's order.
__device__ __forceinline__ float blend(const float (&v)[4], const Sample& s) {
  const float top = v[0] * (1.0f - s.wx) + v[1] * s.wx;
  const float bot = v[2] * (1.0f - s.wx) + v[3] * s.wx;
  return top * (1.0f - s.wy) + bot * s.wy;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy channels [c0, c0 + ncur) of the window of image xb (already offset to its group) into
// win (wh*ww pixels of cc floats, channel fastest); pixels outside the image and channels past
// ncur are zero-filled by the copy itself. vec: 16-byte copies (every address a multiple of 16).
// A thread keeps the channels of one copy and steps over the window's pixels, one division a
// pixel (a chunk has at most 128 channels, so every pass covers at least two pixels).
__device__ __forceinline__ void stage_window(float* win, const float* __restrict__ xb, int c0,
                                             int ncur, int wy0, int wx0, const Plan& pl,
                                             int H, int W, int C, bool vec) {
  const int width = vec ? 4 : 1;
  const int lanes = pl.cc / width;  // copies a pixel
  const int step = blockDim.x / lanes;
  if ((int)threadIdx.x >= step * lanes) return;
  const int c = (threadIdx.x % lanes) * width;
  for (int wp = threadIdx.x / lanes; wp < pl.wh * pl.ww; wp += step) {
    const int wy = wp / pl.ww;
    const int y = wy0 + wy, x = wx0 + wp - wy * pl.ww;
    const bool ok = c < ncur && (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
    const float* src = ok ? xb + ((long long)y * W + x) * C + c0 + c : xb;
    if (vec)
      cp_async16(win + wp * pl.cc + c, src, ok);
    else
      cp_async4(win + wp * pl.cc + c, src, ok);
  }
}

// ---- host side ----

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Checks a call's shapes and its plan; returns 0 or cudaErrorInvalidValue.
inline int check_call(int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
                      int stride, int dil, const Plan& pl, int max_chunk) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || K <= 0 || G <= 0 ||
      GC <= 0 || G * GC != C || stride <= 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  if (pl.th <= 0 || pl.tw <= 0 || pl.cc <= 0 || pl.cc > max_chunk || pl.cpb <= 0 ||
      pl.wh <= 0 || pl.ww <= 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The grid's size and the shared memory of one block must fit the card.
inline int check_size(long long blocks, size_t shared) {
  if (shared > (size_t)kMaxShared || blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Above 48 KB a block's dynamic shared memory must be allowed per kernel (and per device);
// remember the largest size allowed so far so the call is made once, not every launch.
template <typename Kernel>
inline int allow_shared(Kernel kernel, size_t shared, int* allowed) {
  if (shared <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((size_t)allowed[dev] >= shared) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  allowed[dev] = (int)shared;
  return 0;
}

}  // namespace dcnv3
