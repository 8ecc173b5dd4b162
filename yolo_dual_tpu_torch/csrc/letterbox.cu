// Fused letterbox: bilinear resize + centre pad + /255, uint8 NHWC -> float32 NCHW.
//
// Replaces the Pallas TPU kernel yolo_dual_tpu/kernels/preprocess.py:letterbox_normalize
// (pallas_call at :91), which resizes with two matmuls against dense interpolation matrices
// because the TPU has no per-lane gather. Here the resize is separable and direct.
//
// Bound: memory bytes. The least the call must move is the float32 canvas, written once,
// and the 32-byte sectors of each frame that hold a tap of nonzero weight, read once
// (chip_smoke.py:letterbox_bytes); a few flops per output value. At an exact scale of 3
// (1080p -> 640) only every third frame row carries weight, at 1:1 (480p) every row once.
// At batch 1 the 4.9 MB canvas stays in L2 and the call is a chain of latencies.
//
// Design: a thread per `cols` consecutive output pixels of one row, blocks of 32 x `rows`
// threads, more blocks than fit on the card at once, so that one wave's stores overlap the
// next one's loads. A content thread reads its taps' bytes straight from the frame through
// L1, blends each row tap horizontally, then the two rows vertically, and writes one float2
// (or float4) to each of the 3 planes, scalars where S is no multiple of `cols`; a pad
// thread only stores the fill, and columns that straddle the content box's edge take it lane
// by lane. Taps of weight 0 (1080p's 3:1, 480p's 1:1) are skipped; a geometry with none
// (720p's 2:1, any upscale) takes a variant without the branches (kBoth). A block staging
// its rows' frame rows in shared memory with cp.async measured slower at every case the
// port runs (PERF.md): with all blocks resident they copy, wait and store in lockstep.
//
// Taps: the host's tables (kernels/preprocess.py:letterbox_tables), from the float64
// formula of _resize_matrix, so the tap choice carries no float32 rounding; a second tap of
// weight 0 repeats the first. Per content row (tap 0, tap 1, weight 0, weight 1), per content
// column the same with the taps as byte offsets in a frame row. The kernel blends
// horizontally first and folds 1/255 into the row weights; the reference blends rows first
// and divides last: the two differ by float32 rounding only. Stores are plain write-back:
// the first convolution reads the canvas next, from L2.
//
// Plain C interface, built with nvcc into a shared library and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv255 = 1.0f / 255.0f;

struct Args {
  const uint8_t* img;  // (B, H, W, 3)
  float* out;          // (B, 3, S, S)
  const int4* ytab;    // nh rows: (tap 0, tap 1, weight 0 bits, weight 1 bits)
  const int4* xtab;    // nw columns: (byte of tap 0, byte of tap 1, weights' bits)
  int H, W, S, nh, nw, top, left;
  int rows;            // output rows a block
  float fill;          // fill / 255
};

__device__ __forceinline__ float u8f(uint8_t v) {  // exact, without the conversion unit
  return __int_as_float(0x4B000000 | v) - 8388608.0f;
}

// h[3k + c]: channel c of column k, blended horizontally from the frame row at `row`; a
// second tap of weight 0 is skipped unless kBoth.
template <int kCols, bool kBoth>
__device__ __forceinline__ void blend_row(const uint8_t* row, const int4 (&ct)[kCols],
                                          float (&h)[3 * kCols]) {
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const float u = __int_as_float(ct[k].z), v = __int_as_float(ct[k].w);
#pragma unroll
    for (int c = 0; c < 3; ++c) h[3 * k + c] = u * u8f(row[ct[k].x + c]);
    if (kBoth || v != 0.0f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) h[3 * k + c] = fmaf(v, u8f(row[ct[k].y + c]), h[3 * k + c]);
    }
  }
}

// One plane's kCols values at o, v[3k] for column k; a column outside the mask gets fill.
template <int kCols, bool kVec>
__device__ __forceinline__ void store_cols(const Args& a, float* o, int x0, int mask,
                                           const float* v) {
  float r[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) r[k] = (mask >> k & 1) ? v[3 * k] : a.fill;
  if (kVec && kCols == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
  } else if (kVec && kCols == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (x0 + k < a.S) o[k] = r[k];
  }
}

// grid (ceil(S / (32 kCols)), ceil(S / rows), B), block (32, rows). kBoth, where every tap
// of the geometry has nonzero weight: both rows' and both columns' taps are read without a
// branch, and a thread keeps to 32 registers, so that 8 blocks of 256 threads fit on an SM
// (faster at 720p -> 640 than with the branches and no bound: kernels/bench_letterbox.py
// plans, PERF.md); where taps of weight 0 are skipped the branches save more than the
// registers cost.
template <int kCols, bool kVec, bool kBoth>
__global__ void __launch_bounds__(kBoth ? 256 : 512, kBoth ? 8 : 1)
    letterbox_direct_kernel(const Args a) {
  const int x0 = kCols * (blockIdx.x * 32 + threadIdx.x), y = blockIdx.y * a.rows + threadIdx.y;
  const int b = blockIdx.z;
  if (x0 >= a.S || y >= a.S) return;
  const size_t plane = (size_t)a.S * a.S;
  float* o = a.out + (size_t)b * 3 * plane + (size_t)y * a.S + x0;
  const int oy = y - a.top;
  int mask = 0;  // the columns from x0 that lie in the content box
  if (oy >= 0 && oy < a.nh) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int x = x0 + k, ox = x - a.left;
      if (x < a.S && ox >= 0 && ox < a.nw) mask |= 1 << k;
    }
  }
  float v[3 * kCols];
  if (mask) {
    const int4 rt = __ldg(a.ytab + oy);
    int4 ct[kCols];  // a column outside the box takes the box's nearest one, then the fill
#pragma unroll
    for (int k = 0; k < kCols; ++k) ct[k] = __ldg(a.xtab + min(max(x0 + k - a.left, 0), a.nw - 1));
    const uint8_t* frame = a.img + (size_t)b * a.H * a.W * 3;
    const float w0 = __int_as_float(rt.z) * kInv255, w1 = __int_as_float(rt.w) * kInv255;
    float h[3 * kCols];
    if (kBoth) {
      float h1[3 * kCols];
      blend_row<kCols, true>(frame + (size_t)rt.x * a.W * 3, ct, h);
      blend_row<kCols, true>(frame + (size_t)rt.y * a.W * 3, ct, h1);
#pragma unroll
      for (int i = 0; i < 3 * kCols; ++i) v[i] = fmaf(w1, h1[i], w0 * h[i]);
    } else {
      blend_row<kCols, false>(frame + (size_t)rt.x * a.W * 3, ct, h);
#pragma unroll
      for (int i = 0; i < 3 * kCols; ++i) v[i] = w0 * h[i];
      if (w1 != 0.0f) {
        blend_row<kCols, false>(frame + (size_t)rt.y * a.W * 3, ct, h);
#pragma unroll
        for (int i = 0; i < 3 * kCols; ++i) v[i] = fmaf(w1, h[i], v[i]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) store_cols<kCols, kVec>(a, o + c * plane, x0, mask, v + c);
}

template <int kCols, bool kVec>
int launch(const Args& a, int B, bool both, cudaStream_t stream) {
  const dim3 grid((a.S + 32 * kCols - 1) / (32 * kCols), (a.S + a.rows - 1) / a.rows, B);
  if (both)
    letterbox_direct_kernel<kCols, kVec, true><<<grid, dim3(32, a.rows), 0, stream>>>(a);
  else
    letterbox_direct_kernel<kCols, kVec, false><<<grid, dim3(32, a.rows), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One geometry's launch, set up once by the host (kernels/preprocess.py:LaunchParams).
// both: read both taps of every row and column without a branch (for a geometry with no tap
// of weight 0); rows: output rows a block (32 x rows threads); cols: output columns a thread
// (1, 2 or 4).
struct LetterboxLaunch {
  const void* tables;  // nh row entries, then nw column entries
  int H, W, S, nh, nw, top, left, both, rows, cols;
  float fill;
};

extern "C" int letterbox_normalize_launch(const void* img, void* out, int B,
                                          const LetterboxLaunch* p, void* stream) {
  if (p->rows < 1 || 32 * p->rows > (p->both ? 256 : 512) || B > 65535 || p->nh < 1 ||
      p->nw < 1 || (p->cols != 1 && p->cols != 2 && p->cols != 4))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.img = static_cast<const uint8_t*>(img);
  a.out = static_cast<float*>(out);
  a.ytab = static_cast<const int4*>(p->tables);
  a.xtab = a.ytab + p->nh;
  a.H = p->H; a.W = p->W; a.S = p->S; a.nh = p->nh; a.nw = p->nw; a.top = p->top;
  a.left = p->left; a.rows = p->rows; a.fill = p->fill;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = a.S % p->cols == 0, both = p->both != 0;
  switch (p->cols) {
    case 4: return vec ? launch<4, true>(a, B, both, st) : launch<4, false>(a, B, both, st);
    case 2: return vec ? launch<2, true>(a, B, both, st) : launch<2, false>(a, B, both, st);
    default: return launch<1, true>(a, B, both, st);
  }
}

extern "C" const char* letterbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
