// DCNv3 sampling backward, float32, channels-last: given x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK) and the output gradient
// gout (B, Ho, Wo, C), writes dx (B, H, W, C; zeroed by the caller, accumulated here),
// doffset (B, Ho, Wo, G*KK*2) and dmask (B, Ho, Wo, G*KK).
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_bwd
// (pallas_call at :437). The TPU has no per-lane gather or scatter, so that kernel builds a
// one-hot matrix per (row, kernel point, corner) over a band of input rows, gathers the
// corner values as one matmul and scatters dx as its transpose, with a lax.cond escape to
// the plain backward when an offset leaves the band. Hopper gathers and scatters directly:
// this is the reference's dcnv3_col2im form, exact for any offset, with no band.
//
// Design: a block holds TY output pixels of one row-major run and one group (blockIdx.y);
// TX threads per pixel run along that group's GC channels, which are contiguous in NHWC, so
// each corner read of x, each read of gout and each atomic add into dx is coalesced across
// a warp. First the block recomputes each pixel's KK sample geometries into shared memory,
// exactly as csrc/dcnv3.cu computes them (the same __fadd_rn/__fmul_rn order and floorf, so
// the two kernels and the plain version agree on every corner). Then, for each kernel point,
// each thread reads its channels' four corner values and
//   - adds gout*mask*w_corner into the in-range corners of dx (float atomics: the order of
//     the adds, and so dx's last bits, changes from run to run);
//   - sums, over its channels, gout*d(sample)/d(sx), gout*d(sample)/d(sy) and gout*sample;
//     those three partial sums are reduced over the warp by shuffles and over the warps of
//     the pixel by shared-memory atomics, then scaled by mask*offset_scale (doffset) and
//     written once (dmask unscaled).
// Zero padding costs nothing: a corner outside [0, H) x [0, W) reads 0 and receives no add,
// which equals padding, scattering into the padded array and cropping.
//
// Bound: memory bytes. x, offset, mask and gout read once, dx, doffset and dmask written
// once: at 16 x 80 x 80 x 64 about 101 MB, 0.030 ms at 3.35 TB/s. The arithmetic, at
// least 26 FLOP per output value and kernel point, takes less at the float32 rate. The
// 36 atomic adds per output value (9 points x 4 corners) go to L2 and are the likely limit.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>

namespace {

struct Sample {
  int idx[4];    // y*W + x of corners (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1); -1 outside
  float wx, wy;  // bilinear fractions
  float m;       // mask weight
};

__global__ void dcnv3_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const float* __restrict__ gout,
    float* __restrict__ dx, float* __restrict__ doffset, float* __restrict__ dmask,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, float offset_scale) {
  extern __shared__ float smem[];
  const int KK = K * K;
  const int GK = G * KK;
  const int TY = blockDim.y;
  Sample* geo = reinterpret_cast<Sample*>(smem);               // TY * KK
  float* acc = reinterpret_cast<float*>(geo + TY * KK);        // TY * KK * 3: d/dsx, d/dsy, dmask
  const int g = blockIdx.y;
  const long long n_pix = (long long)B * Ho * Wo;
  const long long pix0 = (long long)blockIdx.x * TY;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int half = (dil * (K - 1)) / 2;

  // 1. sample geometry of the block's pixels for group g, one (pixel, point) per thread step
  for (int e = tid; e < TY * KK; e += nthreads) {
    const int ty = e / KK, p = e % KK;
    const long long pix = pix0 + ty;
    Sample s;
    s.idx[0] = s.idx[1] = s.idx[2] = s.idx[3] = -1;
    s.wx = s.wy = s.m = 0.0f;
    if (pix < n_pix) {
      const int ox = (int)(pix % Wo);
      const int oy = (int)((pix / Wo) % Ho);
      const int gp = g * KK + p;
      const float gx = (float)(-half + (p / K) * dil);  // X-major: p = ix*K + iy
      const float gy = (float)(-half + (p % K) * dil);
      const float* off = offset + pix * (2LL * GK) + 2 * gp;
      const float bx = (float)(ox * stride + half) + 0.5f;
      const float by = (float)(oy * stride + half) + 0.5f;
      // the forward kernel's and the plain version's order of operations, without FMAs
      const float sx = __fsub_rn(__fadd_rn(bx, __fmul_rn(offset_scale, __fadd_rn(gx, off[0]))), 0.5f);
      const float sy = __fsub_rn(__fadd_rn(by, __fmul_rn(offset_scale, __fadd_rn(gy, off[1]))), 0.5f);
      const float x0 = floorf(sx), y0 = floorf(sy);
      s.wx = sx - x0;
      s.wy = sy - y0;
      s.m = mask[pix * GK + gp];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float yf = y0 + (float)(c >> 1) - (float)pad;
        const float xf = x0 + (float)(c & 1) - (float)pad;
        if (yf >= 0.0f && yf < (float)H && xf >= 0.0f && xf < (float)W)
          s.idx[c] = (int)yf * W + (int)xf;
      }
    }
    geo[e] = s;
    acc[3 * e] = acc[3 * e + 1] = acc[3 * e + 2] = 0.0f;
  }
  __syncthreads();

  // 2. per kernel point: dx scatter and the three channel sums, threads along the channels
  const long long pix = pix0 + threadIdx.y;
  if (pix < n_pix) {  // uniform across each warp: a warp lies in one threadIdx.y row
    const long long b = pix / ((long long)Ho * Wo);
    const float* xb = x + b * (long long)H * W * C + g * GC;
    float* dxb = dx + b * (long long)H * W * C + g * GC;
    const float* gp = gout + pix * C + g * GC;
    const Sample* sp = geo + threadIdx.y * KK;
    float* ap = acc + threadIdx.y * KK * 3;
    for (int p = 0; p < KK; ++p) {
      const Sample s = sp[p];
      const float w[4] = {(1.0f - s.wx) * (1.0f - s.wy), s.wx * (1.0f - s.wy),
                          (1.0f - s.wx) * s.wy, s.wx * s.wy};
      float dsx = 0.0f, dsy = 0.0f, dm = 0.0f;
      for (int ch = threadIdx.x; ch < GC; ch += blockDim.x) {
        const float go = __ldg(gp + ch);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float u = __ldg(xb + (long long)max(s.idx[c], 0) * C + ch);
          v[c] = s.idx[c] >= 0 ? u : 0.0f;
        }
        const float top = v[0] * (1.0f - s.wx) + v[1] * s.wx;
        const float bot = v[2] * (1.0f - s.wx) + v[3] * s.wx;
        dm += go * (top * (1.0f - s.wy) + bot * s.wy);
        dsx += go * ((1.0f - s.wy) * (v[1] - v[0]) + s.wy * (v[3] - v[2]));
        dsy += go * ((1.0f - s.wx) * (v[2] - v[0]) + s.wx * (v[3] - v[1]));
        const float gm = go * s.m;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (s.idx[c] >= 0) atomicAdd(dxb + (long long)s.idx[c] * C + ch, gm * w[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dsx += __shfl_down_sync(0xffffffffu, dsx, o);
        dsy += __shfl_down_sync(0xffffffffu, dsy, o);
        dm += __shfl_down_sync(0xffffffffu, dm, o);
      }
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(ap + 3 * p, dsx);
        atomicAdd(ap + 3 * p + 1, dsy);
        atomicAdd(ap + 3 * p + 2, dm);
      }
    }
  }
  __syncthreads();

  // 3. doffset = sums x mask x offset_scale (ds/doffset = offset_scale), dmask = sum
  for (int e = tid; e < TY * KK; e += nthreads) {
    const long long q = pix0 + e / KK;
    if (q >= n_pix) continue;
    const int gp = g * KK + e % KK;
    const float scale = geo[e].m * offset_scale;
    doffset[q * (2LL * GK) + 2 * gp] = acc[3 * e] * scale;
    doffset[q * (2LL * GK) + 2 * gp + 1] = acc[3 * e + 1] * scale;
    dmask[q * GK + gp] = acc[3 * e + 2];
  }
}

}  // namespace

extern "C" int dcnv3_backward_launch(
    const void* x, const void* offset, const void* mask, const void* gout,
    void* dx, void* doffset, void* dmask,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, float offset_scale, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || K <= 0 || G <= 0 || G * GC != C || G > 65535)
    return (int)cudaErrorInvalidValue;
  // TX threads on the channels of one group of a pixel (a multiple of 32, at most 256),
  // TY pixels a block
  int tx = ((GC + 31) / 32) * 32;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  const size_t shmem = (size_t)ty * K * K * (sizeof(Sample) + 3 * sizeof(float));
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * Ho * Wo;
  const long long blocks = (n_pix + ty - 1) / ty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dcnv3_backward_kernel<<<dim3((unsigned)blocks, (unsigned)G), dim3(tx, ty), shmem,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask, (const float*)gout,
      (float*)dx, (float*)doffset, (float*)dmask,
      B, H, W, C, Ho, Wo, G, GC, K, stride, pad, dil, offset_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* dcnv3_backward_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
