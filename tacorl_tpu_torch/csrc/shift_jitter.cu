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
//   y = three op slots in the image's order (jitter_common.cuh), or x
//       where apply <= 0.5
//   out = (y - 0.5) / 0.5, float32 (N, 3, out_h, out_w)
//
// off = 0 reads an edge-padded (N, 3, out_h + 2p, out_w + 2p) input, where
// r + dy never leaves the image (the TPU kernel's input); off = p reads the
// unpadded (N, 3, out_h, out_w) image and the clamp is the edge padding, so
// no padded copy is made. The TPU kernel shifted with two one-hot selection
// matmuls per channel; here the shift is an address. dy, dx and the op codes
// come from the float table by truncation, as the TPU kernel casts them.
//
// What bounds it on the H100: bytes (float32 in and out, a few dozen float32
// operations per pixel). Design: each image is split by bands of output rows
// over a cluster of C CTAs (ops/shift_jitter_aug.py:
// shift_jitter_normalize_geometry). A CTA copies its band's source rows,
// whole and clamped, into shared memory with 16-byte cp.async copies, all in
// flight at once; 24-27 KB per CTA at 128x128 (C = 8) instead of a whole
// 196 KB image, so several CTAs share an SM and one CTA's copies overlap
// another's arithmetic. Each thread then reads its pixels at the shifted
// column (thread-consecutive, so free of bank conflicts) into registers,
// runs the chain there, and stores them thread-consecutive (coalesced). The
// contrast slot's mean is a sum over the cluster through distributed shared
// memory: the image is read from device memory once and no pixel is computed
// twice.

#include <cstdint>

#include "jitter_common.cuh"

namespace {

namespace cg = cooperative_groups;
using jitter::kChunk;

constexpr int kFactors = 10;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ void copy16(float* dst_smem, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Thread t holds the band's pixels t + blockDim.x * i, i < P, row-major
// over the band's out_w-wide rows: consecutive threads on consecutive
// pixels. With kVecIn the source rows are copied in 16-byte pieces
// (in_w % 4 == 0 and a 16-byte aligned source), else one float at a time.
template <int K, bool kVecIn>
__global__ void __launch_bounds__(jitter::kMaxThreads)
shift_jitter_normalize_kernel(const float* __restrict__ src, const float* __restrict__ factors,
                              float* __restrict__ out, int in_h, int in_w, int out_h, int out_w,
                              int off, int csize, int band_rows) {
  constexpr int P = K * kChunk;
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // [3][band_rows][in_w]: the clamped source rows
  __shared__ jitter::Scratch scratch;

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long n = blockIdx.x / csize;
  const float* fac = factors + n * kFactors;
  const jitter::Jitter jit = jitter::load_jitter(fac);
  const int dy = static_cast<int>(fac[7]);
  const int dx = static_cast<int>(fac[8]);
  const long long in_plane = static_cast<long long>(in_h) * in_w;
  const float* img = src + n * 3 * in_plane;
  const int r0 = rank * band_rows;
  const int nrows = max(0, min(out_h, r0 + band_rows) - r0);

  // 1. the band's source rows, clamped, into shared memory
  const int per_row = kVecIn ? in_w / 4 : in_w;
  const int lanes_per_row = min(per_row, static_cast<int>(blockDim.x));
  const int rows_per_pass = blockDim.x / lanes_per_row;
  const int tr = threadIdx.x / lanes_per_row, tv = threadIdx.x - tr * lanes_per_row;
  if (tr < rows_per_pass) {
    for (int c = 0; c < 3; ++c) {
      for (int lr = tr; lr < nrows; lr += rows_per_pass) {
        const float* from = img + c * in_plane +
                            static_cast<long long>(clampi(r0 + lr + dy - off, 0, in_h - 1)) * in_w;
        float* to = rows + (c * band_rows + lr) * in_w;
        for (int v = tv; v < per_row; v += lanes_per_row) {
          if (kVecIn) {
            copy16(to + 4 * v, from + 4 * v);
          } else {
            to[v] = __ldg(from + v);
          }
        }
      }
    }
  }
  if (kVecIn) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. this thread's pixels at the shifted columns, scaled, into registers
  const int threads = blockDim.x;
  const int band_px = nrows * out_w;
  const int first = threadIdx.x;
  const int nvalid = clampi((band_px - first + threads - 1) / threads, 0, P);
  const float* rows_r = rows;
  const float* rows_g = rows + band_rows * in_w;
  const float* rows_b = rows + 2 * band_rows * in_w;
  // (row, column) of pixel first + threads * i, stepped without a division
  const int step_rows = threads / out_w, step_cols = threads - step_rows * out_w;
  int lr = first / out_w, q = first - lr * out_w;
  const int shift = dx - off;
  float r[P], g[P], b[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nvalid) {
      const int at = lr * in_w + clampi(q + shift, 0, in_w - 1);
      r[i] = jitter::scale01(rows_r[at]);
      g[i] = jitter::scale01(rows_g[at]);
      b[i] = jitter::scale01(rows_b[at]);
    } else {
      r[i] = g[i] = b[i] = 0.0f;
    }
    lr += step_rows;
    q += step_cols;
    if (q >= out_w) {
      q -= out_w;
      ++lr;
    }
  }

  // 3. the op slots, with the contrast means summed over the cluster
  const bool shared_read =
      jitter::apply_ops(r, g, b, nvalid, jit, out_h * out_w, csize, scratch);

  // 4. normalized, stored thread-consecutive
  const long long out_plane = static_cast<long long>(out_h) * out_w;
  float* dst_r = out + n * 3 * out_plane + static_cast<long long>(r0) * out_w + first;
  float* dst_g = dst_r + out_plane;
  float* dst_b = dst_g + out_plane;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nvalid) {
      dst_r[i * threads] = jitter::normalize(r[i]);
      dst_g[i * threads] = jitter::normalize(g[i]);
      dst_b[i * threads] = jitter::normalize(b[i]);
    }
  }
  // no CTA leaves while another may still read its part of a cluster sum
  if (shared_read) cg::this_cluster().sync();
}

template <int K>
int launch_k(const void* src, const void* factors, void* out, int n, int in_h, int in_w,
             int out_h, int out_w, int off, int csize, int threads, int band_rows, int smem,
             void* stream) {
  const bool vec = in_w % 4 == 0 && reinterpret_cast<std::uintptr_t>(src) % 16 == 0;
  auto run = [&](auto kernel) {
    return jitter::launch_clusters(kernel, n * csize, threads, csize, smem, stream,
                                   static_cast<const float*>(src), static_cast<const float*>(factors),
                                   static_cast<float*>(out), in_h, in_w, out_h, out_w, off, csize,
                                   band_rows);
  };
  return vec ? run(shift_jitter_normalize_kernel<K, true>) : run(shift_jitter_normalize_kernel<K, false>);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs for a band of ``band_rows``
// source rows of ``in_w`` floats in each of the 3 planes.
int shift_jitter_normalize_smem_bytes(int band_rows, int in_w) {
  return static_cast<int>(3 * band_rows * in_w * sizeof(float));
}

// Launches clusters of ``csize`` CTAs of ``threads`` threads per image, each
// CTA owning ``band_rows`` output rows and each thread ``k`` x 8 pixels, on
// ``stream`` (the geometry of shift_jitter_normalize_geometry). Returns 0, a
// CUDA error code, or -1 when the cluster shape cannot be scheduled.
int shift_jitter_normalize_launch(const void* src, const void* factors, void* out, int n,
                                  int in_h, int in_w, int out_h, int out_w, int off, int csize,
                                  int threads, int k, int band_rows, void* stream) {
  const bool shape_ok = (csize == 1 || csize == 2 || csize == 4 || csize == 8) &&
                        (k == 1 || k == 2 || k == 4) && threads % 32 == 0 && threads > 0 &&
                        threads <= jitter::kMaxThreads && band_rows > 0 &&
                        csize * band_rows >= out_h &&
                        threads * k * kChunk >= band_rows * out_w;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shift_jitter_normalize_smem_bytes(band_rows, in_w);
  switch (k) {
    case 1: return launch_k<1>(src, factors, out, n, in_h, in_w, out_h, out_w, off, csize, threads, band_rows, smem, stream);
    case 2: return launch_k<2>(src, factors, out, n, in_h, in_w, out_h, out_w, off, csize, threads, band_rows, smem, stream);
    default: return launch_k<4>(src, factors, out, n, in_h, in_w, out_h, out_w, off, csize, threads, band_rows, smem, stream);
  }
}

}  // extern "C"
