// Device code shared by the two colour-jitter kernels (jitter_normalize.cu
// and shift_jitter.cu): the scale/clip of a loaded value, the three op
// slots of an image's factor row, the hue chain, and the grayscale sum over
// a thread-block cluster that gives the contrast slot its mean.
//
// Each image is split over the CTAs of one cluster; each thread holds P
// pixels of the image in registers (r[P], g[P], b[P]) from the load to the
// store, so no pixel is read from device memory twice or computed twice.
// Which pixels a thread holds is the kernel's business: the chain only needs
// to know that the first ``nvalid`` of them lie inside the image.
//
// Semantics are those of the TPU kernels' bodies
// (tacorl_tpu/ops/pallas_aug.py:_jitter_kernel, _shift_jitter_kernel): any
// op row is allowed (0 brightness, 1 contrast, anything else hue, per slot;
// a contrast slot takes the mean of the grayscale image as it stands at
// that slot), op codes come from the float table by truncation, and the
// RGB->HSV ties keep maxc == r first, then maxc == g.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace jitter {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;   // threads of one CTA, at most
constexpr int kChunk = 8;          // pixels of a plane in one 16-byte bf16 access
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);  // rounded as JAX rounds it
constexpr int kUnschedulable = -1;  // launch status: the cluster shape cannot be scheduled

// clip(v, 0, 1) as the saturating form of the instruction that makes v
// (FMUL.SAT, FFMA.SAT): the same value for every finite v
__device__ __forceinline__ float clip01(float v) { return __saturatef(v); }

// clip(x / 255, 0, 1), as x * (1 / 255)
__device__ __forceinline__ float scale01(float v) { return clip01(v * kInv255); }

// (y - 0.5) / 0.5, which is exactly 2y - 1 rounded once
__device__ __forceinline__ float normalize(float v) { return fmaf(v, 2.0f, -1.0f); }

// 1 / v to within an ulp or so, one MUFU.RCP; a subnormal v counts as 0
// (the callers keep such v away from it)
__device__ __forceinline__ float rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

// One image's factor row, decoded once per thread.
struct Jitter {
  float bf, cf;
  float hue6;  // the hue offset in sixths of a turn, floor-mod 6: in [0, 6]
  int ops;     // op of slot s in bits 2s..2s+1: 0 brightness, 1 contrast, 2 hue
  bool apply;
  bool any_contrast;
};

__device__ __forceinline__ Jitter load_jitter(const float* fac) {
  Jitter j;
  j.bf = fac[0];
  j.cf = fac[1];
  const float h = fac[2];
  j.hue6 = 6.0f * (h - floorf(h));
  j.ops = 0;
  j.any_contrast = false;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int op = static_cast<int>(fac[3 + s]);  // truncation, as the TPU kernel casts
    const int code = op == 0 ? 0 : (op == 1 ? 1 : 2);
    j.ops |= code << (2 * s);
    j.any_contrast |= code == 1;
  }
  j.apply = fac[6] > 0.5f;
  return j;
}

// RGB -> HSV, h + offset (mod 1), HSV -> RGB, with h in sixths of a turn.
// Against the TPU kernel's helpers: one approximate reciprocal of the hue's
// denominator instead of three divisions, the three hue branches as selects
// of a numerator and an offset, and HSV -> RGB without the sector's integer:
// each channel is p + v s c(k) with c the clamped triangle
// sat(|k mod 6 - 3| - 1) at the channel's own phase k of the hue, which
// equals the six-way select of (v, p, q, t) on every sector and is
// continuous across sector edges. So the results differ from the TPU
// kernel's by rounding only, a few float32 ulps. A denominator below
// FLT_MIN is taken as 0, as d = 0 and maxc = 0 are: the values it would
// scale are below FLT_MIN themselves.
__device__ __forceinline__ float hue_channel(float k3, float p, float vs) {
  // k3 = k - 3: c = sat(|k3 - 6 floor((k3 + 3) / 6)| - 1), the mod up to
  // rounding, which c's flat top at k = 0 (mod 6) absorbs
  const float m = fmaf(-6.0f, floorf(fmaf(k3, 1.0f / 6.0f, 0.5f)), k3);
  return fmaf(vs, __saturatef(fabsf(m) - 1.0f), p);
}

__device__ __forceinline__ void hue_shift(float& r, float& g, float& b, float hue6) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float d = maxc - minc;
  const bool chroma = d >= kMinNormal;
  const float inv_d = rcp(chroma ? d : 1.0f);
  const float s = maxc >= kMinNormal ? d * rcp(maxc) : 0.0f;
  // maxc == r: (g - b) / d; maxc == g: 2 + (b - r) / d; else 4 + (r - g) / d
  const bool is_r = maxc == r, is_g = maxc == g;
  const float num = is_r ? g - b : (is_g ? b - r : r - g);
  const float base = is_r ? 0.0f : (is_g ? 2.0f : 4.0f);
  const float h = chroma ? fmaf(num, inv_d, base) : 0.0f;  // in [-1, 5]
  const float k3 = h + (hue6 - 3.0f);  // the hue in sixths, minus 3: in [-4, 8]
  const float vs = maxc * s;
  const float p = maxc - vs;  // v (1 - s)
  r = hue_channel(k3, p, vs);
  g = hue_channel(k3 + 4.0f, p, vs);
  b = hue_channel(k3 + 2.0f, p, vs);
}

// Reduction scratch of one CTA: one partial per warp, and the CTA's part of
// the cluster sum for each op slot (a slot of its own, so no slot is reused).
struct Scratch {
  float warp[kMaxThreads / 32];
  float part[3];
};

// Sum of ``v`` over every thread of the cluster. Each CTA reduces its
// threads (warp shuffles, then shared memory) and publishes the total in
// its own shared memory; after cluster.sync() lane i of every warp reads
// rank i's part through distributed shared memory (one round trip), and the
// warp adds the parts in rank order, so every CTA gets the same,
// deterministic total. All threads of the cluster call it; csize <= 32.
__device__ float cluster_sum(float v, int slot, int csize, Scratch& s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) s.warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s.warp[w];
    s.part[slot] = total;
  }
  // also the block barrier that lets the next call reuse s.warp
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const float part = lane < csize ? *cluster.map_shared_rank(&s.part[slot], lane) : 0.0f;
  float total = 0.0f;
  for (int rank = 0; rank < csize; ++rank) total += __shfl_sync(0xffffffffu, part, rank);
  return total;
}

// The three op slots over a thread's P pixels, of which the first ``nvalid``
// lie in the image; ``hw`` is the image's pixel count. Uniform across the
// cluster (one image), so the op branches do not diverge. Returns whether
// the cluster's shared memory was read, in which case the caller must
// cluster.sync() before exiting.
template <int P>
__device__ __forceinline__ bool apply_ops(float (&r)[P], float (&g)[P], float (&b)[P], int nvalid,
                                          const Jitter& j, int hw, int csize, Scratch& s) {
  if (!j.apply) return false;
#pragma unroll 1
  for (int slot = 0; slot < 3; ++slot) {
    const int op = (j.ops >> (2 * slot)) & 3;
    if (op == 0) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        r[i] = clip01(r[i] * j.bf);
        g[i] = clip01(g[i] * j.bf);
        b[i] = clip01(b[i] * j.bf);
      }
    } else if (op == 1) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float gray = fmaf(0.2989f, r[i], fmaf(0.587f, g[i], 0.114f * b[i]));
        acc += i < nvalid ? gray : 0.0f;
      }
      const float mean = cluster_sum(acc, slot, csize, s) / static_cast<float>(hw);
      const float shift = (1.0f - j.cf) * mean;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        r[i] = clip01(fmaf(j.cf, r[i], shift));
        g[i] = clip01(fmaf(j.cf, g[i], shift));
        b[i] = clip01(fmaf(j.cf, b[i], shift));
      }
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) hue_shift(r[i], g[i], b[i], j.hue6);
    }
  }
  return j.any_contrast;
}

// Launches ``kernel`` as clusters of ``csize`` CTAs along x on ``stream``.
// The shape is first checked with cudaOccupancyMaxActiveClusters (once per
// kernel and shape); one that cannot be scheduled returns kUnschedulable,
// anything else the CUDA status of the launch.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int grid, int threads, int csize, int smem,
                    void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;

  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, int, int>, int> checked;
  static std::map<const void*, int> smem_ceiling;
  const void* id = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(id, threads, csize, smem);
  int clusters;
  cudaError_t err;
  {
    std::lock_guard<std::mutex> lock(mutex);
    auto it = checked.find(key);
    if (it == checked.end()) {
      // the attribute is a ceiling per kernel: only ever raise it
      int& ceiling = smem_ceiling[id];
      if (smem > ceiling) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        ceiling = smem;
      }
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return static_cast<int>(err);
      checked[key] = clusters;
    } else {
      clusters = it->second;
    }
  }
  if (clusters < 1) return kUnschedulable;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jitter
