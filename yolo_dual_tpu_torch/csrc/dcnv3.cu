// DCNv3 forward sampling, float32, channels-last: x (B, H, W, C = G*GC), offset
// (B, Ho, Wo, G*KK*2) as (dx, dy) pairs, mask (B, Ho, Wo, G*KK) -> out (B, Ho, Wo, C).
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_impl
// (pallas_call at :252). The TPU has no per-lane gather, so that kernel folds the kk
// bilinear samples of each output row into a one-hot gather matrix over a band of input
// rows and runs one matmul per row, with a lax.cond escape to the plain core when an
// offset leaves the band. Hopper gathers directly: this kernel reads the four corners of
// each sample itself, so it is exact for any offset and needs no band.
//
// Design: a block holds TY output pixels of one row-major run; TX threads per pixel run
// along its C channels, which are contiguous in NHWC, so each corner read of a warp is
// one coalesced load. First the block reads each pixel's kk (dx, dy) pairs and kk mask
// values once and computes the sample geometry into shared memory (the coordinates of
// yolo_dual_tpu/nn/dcn.py:dcnv3_coords: s = base + offset_scale*(grid + d) - 0.5 in
// padded-input pixels, base = i*stride + dil*(k-1)/2 + 0.5, kernel points X-major,
// p = ix*k + iy); nothing of it goes to device memory. Zero padding costs no copy: a
// corner at padded (y, x) reads the unpadded input at (y - pad, x - pad) when that lies
// inside [0, H) x [0, W) and counts 0 otherwise, which equals padding then checking the
// padded range. Then each thread sums, in float32 and in a fixed order (kk, then the
// corners as the plain version blends them), the mask-weighted samples of its channels.
//
// Bound: memory bytes. x is read once (from L2 across the neighbouring pixels that share
// corners), offset and mask once, out written once: at 32 x 80 x 80 x 64 that is
// 52.4 + 14.7 + 7.4 + 52.4 = 127 MB, ~38 us at 3.35 TB/s. The arithmetic, 11 FLOP per
// output value and sample point (99 at kk = 9), stays below that time at the float32
// rate. At batch 1 a call moves 1-4 MB (bound ~0.3-1.2 us) and is bound by its launch.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include <cuda_runtime.h>

namespace {

struct Sample {
  int idx[4];    // y*W + x of corners (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1); -1 outside
  float wx, wy;  // bilinear fractions
  float m;       // mask weight
};

__global__ void dcnv3_sampling_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, float* __restrict__ out,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, float offset_scale) {
  extern __shared__ Sample smem[];
  const int KK = K * K;
  const int GK = G * KK;
  const int TY = blockDim.y;
  const long long n_pix = (long long)B * Ho * Wo;
  const long long pix0 = (long long)blockIdx.x * TY;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int half = (dil * (K - 1)) / 2;

  // 1. sample geometry of the block's pixels, one (pixel, group, point) per thread step
  for (int e = tid; e < TY * GK; e += nthreads) {
    const int ty = e / GK, gp = e % GK;
    const long long pix = pix0 + ty;
    Sample s;
    s.idx[0] = s.idx[1] = s.idx[2] = s.idx[3] = -1;
    s.wx = s.wy = s.m = 0.0f;
    if (pix < n_pix) {
      const int ox = (int)(pix % Wo);
      const int oy = (int)((pix / Wo) % Ho);
      const int p = gp % KK;
      const float gx = (float)(-half + (p / K) * dil);  // X-major: p = ix*K + iy
      const float gy = (float)(-half + (p % K) * dil);
      const float* off = offset + pix * (2LL * GK) + 2 * gp;
      const float bx = (float)(ox * stride + half) + 0.5f;
      const float by = (float)(oy * stride + half) + 0.5f;
      // the plain version's order of operations, without contraction into FMAs
      const float sx = __fsub_rn(__fadd_rn(bx, __fmul_rn(offset_scale, __fadd_rn(gx, off[0]))), 0.5f);
      const float sy = __fsub_rn(__fadd_rn(by, __fmul_rn(offset_scale, __fadd_rn(gy, off[1]))), 0.5f);
      const float x0 = floorf(sx), y0 = floorf(sy);  // floor(-0.5) is -1, not 0
      s.wx = sx - x0;
      s.wy = sy - y0;
      s.m = mask[pix * GK + gp];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // unpadded corner coordinates, compared as floats so no huge offset overflows an int
        const float yf = y0 + (float)(c >> 1) - (float)pad;
        const float xf = x0 + (float)(c & 1) - (float)pad;
        if (yf >= 0.0f && yf < (float)H && xf >= 0.0f && xf < (float)W)
          s.idx[c] = (int)yf * W + (int)xf;
      }
    }
    smem[e] = s;
  }
  __syncthreads();

  // 2. mask-weighted bilinear sum, threads along the channels of one pixel
  const long long pix = pix0 + threadIdx.y;
  if (pix >= n_pix) return;
  const long long b = pix / ((long long)Ho * Wo);
  const float* xb = x + b * (long long)H * W * C;
  const Sample* sp = smem + threadIdx.y * GK;
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    const Sample* sg = sp + (ch / GC) * KK;
    float acc = 0.0f;
    for (int p = 0; p < KK; ++p) {
      const Sample s = sg[p];
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // branch-free: an outside corner loads pixel 0 and counts 0, as the plain version
        const float u = __ldg(xb + (long long)max(s.idx[c], 0) * C + ch);
        v[c] = s.idx[c] >= 0 ? u : 0.0f;
      }
      const float top = v[0] * (1.0f - s.wx) + v[1] * s.wx;
      const float bot = v[2] * (1.0f - s.wx) + v[3] * s.wx;
      acc += (top * (1.0f - s.wy) + bot * s.wy) * s.m;
    }
    out[pix * C + ch] = acc;
  }
}

}  // namespace

extern "C" int dcnv3_sampling_launch(
    const void* x, const void* offset, const void* mask, void* out,
    int B, int H, int W, int C, int Ho, int Wo, int G, int GC, int K,
    int stride, int pad, int dil, float offset_scale, void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 || K <= 0 || G <= 0 || G * GC != C)
    return (int)cudaErrorInvalidValue;
  // TX threads on the channels of a pixel (a multiple of 32, at most 256), TY pixels a block
  int tx = ((C + 31) / 32) * 32;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  const size_t shmem = (size_t)ty * G * K * K * sizeof(Sample);
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * Ho * Wo;
  const long long blocks = (n_pix + ty - 1) / ty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dcnv3_sampling_kernel<<<(unsigned)blocks, dim3(tx, ty), shmem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask, (float*)out,
      B, H, W, C, Ho, Wo, G, GC, K, stride, pad, dil, offset_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* dcnv3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
