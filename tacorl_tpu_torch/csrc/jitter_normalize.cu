// Fused colour jitter + normalize: a hand-written CUDA kernel for Hopper
// (sm_90a).
//
// Replaces tacorl_tpu/ops/pallas_aug.py:_jitter_kernel (launched by
// fused_jitter_normalize). Per image n of a planar (N, 3, H, W) batch in
// 0..255, float32 or bfloat16 in and out, float32 math, with the (N, 8)
// float32 factor table [brightness, contrast, hue, op0, op1, op2, apply, pad]:
//
//   x = clip(img / 255, 0, 1)
//   y = three op slots in the image's order (jitter_common.cuh), or x
//       where apply <= 0.5
//   out = (y - 0.5) / 0.5, in the input dtype (bf16 rounds to nearest even)
//
// What bounds it on the H100: bytes, and then the issue rate of its float32
// arithmetic (the hue chain), which at bf16 IO is of the same order. Design:
// each image is split by bands of pixels over a cluster of C CTAs (C of 1-8,
// chosen by ops/jitter_aug.py:jitter_normalize_geometry so that even a
// 64-image call puts hundreds of CTAs on the card). Each thread loads its
// pixels once, 8 consecutive pixels of a plane per 16-byte bf16 access (two
// for float32), keeps them in registers through the whole chain, and stores
// them with the same wide accesses. A contrast slot's grayscale mean is a sum
// over the cluster through distributed shared memory, so the image is read
// from device memory once and no pixel is computed twice. Small CTAs with
// all their loads issued at once keep several CTAs' loads in flight per SM.

#include <cuda_bf16.h>

#include <cstdint>

#include "jitter_common.cuh"

namespace {

namespace cg = cooperative_groups;
using jitter::kChunk;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load_vec(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store_vec(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  // a bf16 is the high half of its float32: one shift or mask a value
  static __device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(words[k] << 16);
      v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
    unsigned words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      words[k] = *reinterpret_cast<const unsigned*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// Thread t of CTA ``rank`` holds chunks rank * band + t + k * blockDim.x of
// each plane, k < K: consecutive threads on consecutive 16-byte chunks. With
// kVec every chunk lies wholly inside or outside the plane (hw % 8 == 0, and
// the pointers are 16-byte aligned); otherwise the last chunk is cut with
// scalar accesses.
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(jitter::kMaxThreads)
jitter_normalize_kernel(const T* __restrict__ src, const float* __restrict__ factors,
                        T* __restrict__ out, int hw, int csize, int band_chunks) {
  constexpr int P = K * kChunk;
  __shared__ jitter::Scratch scratch;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long n = blockIdx.x / csize;
  const jitter::Jitter jit = jitter::load_jitter(factors + n * 8);
  const long long plane = hw;
  const T* img = src + n * 3 * plane;
  T* dst = out + n * 3 * plane;

  // pixel offset in the plane of each of this thread's chunks. Both the
  // chunk index and the pixel offset grow with k, so the pixels that lie in
  // the band and in the plane are the first ``nvalid`` of the thread's P.
  int at[K];
  int nvalid = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int local = threadIdx.x + k * blockDim.x;
    at[k] = (rank * band_chunks + local) * kChunk;
    const int left = hw - at[k];
    if (local < band_chunks && left > 0) nvalid = k * kChunk + min(kChunk, left);
  }

  // loaded and scaled; a pixel outside the image is 0
  auto load = [&](float* v, const T* p, int first) {
    if (kVec) {
      if (first < nvalid) {
        Io<T>::load_vec(p, v);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) v[e] = jitter::scale01(v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) v[e] = 0.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        v[e] = first + e < nvalid ? jitter::scale01(Io<T>::load(p + e)) : 0.0f;
    }
  };
  auto store = [&](T* p, const float* v, int first) {
    if (kVec) {
      if (first < nvalid) Io<T>::store_vec(p, v);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (first + e < nvalid) Io<T>::store(p + e, v[e]);
    }
  };

  float r[P], g[P], b[P];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load(r + k * kChunk, img + at[k], k * kChunk);
    load(g + k * kChunk, img + plane + at[k], k * kChunk);
    load(b + k * kChunk, img + 2 * plane + at[k], k * kChunk);
  }

  const bool shared_read = jitter::apply_ops(r, g, b, nvalid, jit, hw, csize, scratch);

#pragma unroll
  for (int i = 0; i < P; ++i) {
    r[i] = jitter::normalize(r[i]);
    g[i] = jitter::normalize(g[i]);
    b[i] = jitter::normalize(b[i]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    store(dst + at[k], r + k * kChunk, k * kChunk);
    store(dst + plane + at[k], g + k * kChunk, k * kChunk);
    store(dst + 2 * plane + at[k], b + k * kChunk, k * kChunk);
  }
  // no CTA leaves while another may still read its part of a cluster sum
  if (shared_read) cg::this_cluster().sync();
}

template <typename T, int K>
int launch_k(const void* src, const void* factors, void* out, int n, int hw, int csize,
             int threads, int band_chunks, void* stream) {
  const bool vec = hw % kChunk == 0 && reinterpret_cast<std::uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  auto args = [&](auto kernel) {
    return jitter::launch_clusters(kernel, n * csize, threads, csize, 0, stream,
                                   static_cast<const T*>(src), static_cast<const float*>(factors),
                                   static_cast<T*>(out), hw, csize, band_chunks);
  };
  return vec ? args(jitter_normalize_kernel<T, K, true>) : args(jitter_normalize_kernel<T, K, false>);
}

template <typename T>
int launch_t(const void* src, const void* factors, void* out, int n, int hw, int csize,
             int threads, int k, int band_chunks, void* stream) {
  switch (k) {
    case 1: return launch_k<T, 1>(src, factors, out, n, hw, csize, threads, band_chunks, stream);
    case 2: return launch_k<T, 2>(src, factors, out, n, hw, csize, threads, band_chunks, stream);
    default: return launch_k<T, 4>(src, factors, out, n, hw, csize, threads, band_chunks, stream);
  }
}

}  // namespace

extern "C" {

// Launches clusters of ``csize`` CTAs of ``threads`` threads per image, each
// thread holding ``k`` chunks of 8 pixels of a band of ``band_chunks``
// chunks, on ``stream`` (the geometry of jitter_normalize_geometry).
// ``bf16`` selects bfloat16 IO, else float32. Returns 0, a CUDA error code,
// or -1 when the cluster shape cannot be scheduled.
int jitter_normalize_launch(const void* src, const void* factors, void* out, int n, int hw,
                            int bf16, int csize, int threads, int k, int band_chunks,
                            void* stream) {
  const bool shape_ok = (csize == 1 || csize == 2 || csize == 4 || csize == 8) &&
                        (k == 1 || k == 2 || k == 4) && threads % 32 == 0 && threads > 0 &&
                        threads <= jitter::kMaxThreads && threads * k >= band_chunks &&
                        static_cast<long long>(csize) * band_chunks * kChunk >= hw;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_t<__nv_bfloat16>(src, factors, out, n, hw, csize, threads, k, band_chunks, stream)
              : launch_t<float>(src, factors, out, n, hw, csize, threads, k, band_chunks, stream);
}

}  // extern "C"
