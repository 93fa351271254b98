// Fused DrQ shift + colour jitter + normalize: a hand-written CUDA kernel
// for Hopper (sm_90a).
//
// Replaces tacorl_tpu/ops/pallas_aug.py:_shift_jitter_kernel (launched by
// fused_shift_jitter_normalize). Per image n of a planar float32 batch in
// 0..255, with the (N, 10) float32 factor table
// [brightness, contrast, hue, op0, op1, op2, apply, dy, dx, pad]:
//
//   x[c, r, q] = clip(src[c, clamp(r + dy - off, 0, in_h - 1),
//                           clamp(q + dx - off, 0, in_w - 1)] / 255, 0, 1)
//   y = three op slots in the image's order (0 brightness, 1 contrast
//       around the mean of the grayscale image as it stands at that slot,
//       anything else hue), or x where apply <= 0.5
//   out = (y - 0.5) / 0.5, float32 (N, 3, out_h, out_w)
//
// off = 0 reads an edge-padded (N, 3, out_h + 2p, out_w + 2p) input, where
// r + dy never leaves the image (the TPU kernel's input); off = p reads the
// unpadded (N, 3, out_h, out_w) image and the clamp is the edge padding, so
// no padded copy is made. The TPU kernel shifted with two one-hot selection
// matmuls per channel; here the shift is the offset of the load. dy, dx and
// the op codes come from the float table by truncation, as the TPU kernel
// casts them.
//
// What bounds it: bytes. Each image is read once and written once
// (production: 1024 x 3 x 128 x 128 float32 each way) and the arithmetic is
// a few dozen float32 operations per pixel. Design: one block per image; the
// shifted, scaled image lives in dynamic shared memory (3 x 128 x 128 x 4 =
// 196,608 bytes at the production size), so the contrast slot's grayscale
// mean, a block reduction, needs no second read of device memory. Every
// thread owns the same pixels in every pass, so only the reductions need
// barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kFactors = 10;

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// floor-mod by 1, as jnp's float % (the result takes the divisor's sign)
__device__ __forceinline__ float mod1(float v) { return v - floorf(v); }

// RGB -> HSV, h + delta (mod 1), HSV -> RGB; the guards and the tie order
// (maxc == r first, then maxc == g) of the TPU kernel's helpers
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b, float delta) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float d = maxc - minc;
  const float safe_d = d > 0.0f ? d : 1.0f;
  const float s = maxc > 0.0f ? d / (maxc > 0.0f ? maxc : 1.0f) : 0.0f;
  const float rc = (maxc - r) / safe_d;
  const float gc = (maxc - g) / safe_d;
  const float bc = (maxc - b) / safe_d;
  float h = maxc == r ? bc - gc : (maxc == g ? 2.0f + rc - bc : 4.0f + gc - rc);
  h = d > 0.0f ? h : 0.0f;
  h = mod1(mod1(h / 6.0f) + delta);
  const float fi = floorf(h * 6.0f);
  const float f = h * 6.0f - fi;
  const float v = maxc;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - f * s);
  const float t = v * (1.0f - (1.0f - f) * s);
  const int i = static_cast<int>(fi) % 6;  // h * 6 can round to 6.0
  r = (i == 0 || i == 5) ? v : (i == 1 ? q : (i == 4 ? t : p));
  g = (i == 1 || i == 2) ? v : (i == 0 ? t : (i == 3 ? q : p));
  b = (i == 3 || i == 4) ? v : (i == 2 ? t : (i == 5 ? q : p));
}

// Sum of one value per thread over the block; every thread gets the total.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  const float total = scratch[32];
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
shift_jitter_normalize_kernel(const float* __restrict__ src, const float* __restrict__ factors,
                              float* __restrict__ out, int in_h, int in_w, int out_h, int out_w,
                              int off) {
  extern __shared__ float smem[];
  const int hw = out_h * out_w;
  float* img = smem;             // 3 * hw: the shifted, scaled image
  float* scratch = smem + 3 * hw;  // 33 floats for the reductions

  const long long n = blockIdx.x;
  const float* fac = factors + n * kFactors;
  const float bf = fac[0], cf = fac[1], hf = fac[2];
  const bool apply = fac[6] > 0.5f;
  const int dy = static_cast<int>(fac[7]);
  const int dx = static_cast<int>(fac[8]);
  const long long in_plane = static_cast<long long>(in_h) * in_w;
  const float* base = src + n * 3 * in_plane;
  const float inv255 = static_cast<float>(1.0 / 255.0);

  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int r = p / out_w, q = p - (p / out_w) * out_w;
    const long long at = static_cast<long long>(clampi(r + dy - off, 0, in_h - 1)) * in_w +
                         clampi(q + dx - off, 0, in_w - 1);
    img[p] = clip01(base[at] * inv255);
    img[hw + p] = clip01(base[in_plane + at] * inv255);
    img[2 * hw + p] = clip01(base[2 * in_plane + at] * inv255);
  }

  if (apply) {
    for (int slot = 0; slot < 3; ++slot) {
      const int op = static_cast<int>(fac[3 + slot]);
      float mean = 0.0f;
      if (op == 1) {
        float acc = 0.0f;
        for (int p = threadIdx.x; p < hw; p += blockDim.x)
          acc += 0.2989f * img[p] + 0.587f * img[hw + p] + 0.114f * img[2 * hw + p];
        mean = block_sum(acc, scratch) / static_cast<float>(hw);
      }
      for (int p = threadIdx.x; p < hw; p += blockDim.x) {
        float r = img[p], g = img[hw + p], b = img[2 * hw + p];
        if (op == 0) {
          r = clip01(r * bf);
          g = clip01(g * bf);
          b = clip01(b * bf);
        } else if (op == 1) {
          const float shift = (1.0f - cf) * mean;
          r = clip01(cf * r + shift);
          g = clip01(cf * g + shift);
          b = clip01(cf * b + shift);
        } else {
          hue_shift(r, g, b, hf);
        }
        img[p] = r;
        img[hw + p] = g;
        img[2 * hw + p] = b;
      }
    }
  }

  float* dst = out + n * 3 * static_cast<long long>(hw);
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    dst[p] = (img[p] - 0.5f) / 0.5f;
    dst[hw + p] = (img[hw + p] - 0.5f) / 0.5f;
    dst[2 * hw + p] = (img[2 * hw + p] - 0.5f) / 0.5f;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for an out_h x out_w image.
int shift_jitter_normalize_smem_bytes(int out_h, int out_w) {
  return static_cast<int>((3 * out_h * out_w + 33) * sizeof(float));
}

// Launches one block per image on ``stream``; returns cudaGetLastError().
int shift_jitter_normalize_launch(const void* src, const void* factors, void* out, int n,
                                  int in_h, int in_w, int out_h, int out_w, int off,
                                  void* stream) {
  const int smem = shift_jitter_normalize_smem_bytes(out_h, out_w);
  cudaError_t err = cudaFuncSetAttribute(shift_jitter_normalize_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shift_jitter_normalize_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(factors),
      static_cast<float*>(out), in_h, in_w, out_h, out_w, off);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
