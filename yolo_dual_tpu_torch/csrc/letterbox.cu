// Fused letterbox: bilinear resize + center pad + /255, uint8 NHWC -> float32 NCHW.
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/preprocess.py:letterbox_normalize
// (pallas_call at :91). The TPU kernel resizes with two matmuls against dense
// interpolation matrices, because the TPU has no per-lane gather. Here each thread
// computes one output pixel directly: inside the content box it reads the 4 uint8 taps
// of each channel and blends them (rows first, then columns, the order of the TPU
// kernel's two matmuls); outside it writes fill/255. The taps and weights come from
// per-axis tables the host builds with the float64 formula of _resize_matrix, so the
// tap choice carries no float32 rounding.
//
// Bound: memory bytes (uint8 frame read once, float32 canvas written once; about
// 4 flops per output value). A 1080p -> 640 frame is 6.2 MB in + 4.9 MB out, about
// 11 MB, ~3.3 us at 3.35 TB/s. At that exact scale of 3 only every third row holds a
// tap of nonzero weight (the second row tap has weight 0 and is not read), so the
// least it must move is 2.1 MB in + 4.9 MB out, ~2.1 us: at batch 1 the call is
// bound by its launch. The output is NCHW, the port's layout, so no transpose follows.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void letterbox_normalize_kernel(
    const uint8_t* __restrict__ img, float* __restrict__ out, int H, int W, int S,
    const int2* __restrict__ ytap, const float2* __restrict__ yw, int nh, int top,
    const int2* __restrict__ xtap, const float2* __restrict__ xw, int nw, int left,
    float fill) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= S || y >= S) return;
  const size_t plane = (size_t)S * S;
  float* o = out + (size_t)b * 3 * plane + (size_t)y * S + x;
  const int oy = y - top, ox = x - left;
  if (oy < 0 || oy >= nh || ox < 0 || ox >= nw) {
    const float v = fill / 255.0f;
    o[0] = v;
    o[plane] = v;
    o[2 * plane] = v;
    return;
  }
  const int2 ty = ytap[oy];
  const float2 wy = yw[oy];
  const int2 tx = xtap[ox];
  const float2 wx = xw[ox];
  const uint8_t* frame = img + (size_t)b * H * W * 3;
  const uint8_t* r0 = frame + (size_t)ty.x * W * 3;
  // a zero-weight row tap re-reads row r0 (0 * v adds exactly 0) instead of its own row
  const uint8_t* r1 = wy.y != 0.0f ? frame + (size_t)ty.y * W * 3 : r0;
  const int c0 = tx.x * 3, c1 = tx.y * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v0 = wy.x * (float)r0[c0 + c] + wy.y * (float)r1[c0 + c];  // column tap 0
    const float v1 = wy.x * (float)r0[c1 + c] + wy.y * (float)r1[c1 + c];  // column tap 1
    o[c * plane] = (wx.x * v0 + wx.y * v1) / 255.0f;
  }
}

}  // namespace

extern "C" int letterbox_normalize_launch(
    const void* img, void* out, int B, int H, int W, int S,
    const void* ytap, const void* yw, int nh, int top,
    const void* xtap, const void* xw, int nw, int left,
    float fill, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((S + block.x - 1) / block.x, (S + block.y - 1) / block.y, B);
  letterbox_normalize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (float*)out, H, W, S,
      (const int2*)ytap, (const float2*)yw, nh, top,
      (const int2*)xtap, (const float2*)xw, nw, left, fill);
  return (int)cudaGetLastError();
}

extern "C" const char* letterbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
