// Batched per-point image gather with bf16 rounding, for Hopper (sm_90a).
//
//   out[n, q] = float(bf16_rne(img[n, vi[n, q], ui[n, q]]))
//
// Replaces the TPU kernel gennbv_tpu/ops/pallas_gather.py::_kernel (called
// through pallas_gather.gather_image), which reads the same values as one
// one-hot dot per 512-point chunk so that the TPU's matrix unit does the
// lookup.  A GPU reads the value directly.
//
// What bounds it on an H100: the index and output streams, not the image.
// Each query moves 12 bytes that no cache can spare (two int32 indices in,
// one float32 out), while an env's queries hit few distinct pixels.  On the
// rollout's path (256 envs, 128x128 images, 8000 carve points an env) the
// streams are 24.6 MB, 7.3 us at 3.35 TB/s, and the distinct pixels 1-2
// MB: roughly 1-2k of an env's 16,384, each read 4-8 times, from L2 and
// the read-only L1 path.  Staging whole images in shared memory would read
// all 16.8 MB of them to save re-reads of 1-2 MB, so it is not done.
//
// What the design does about it: more bytes in flight a thread, and the
// streams moved 16 bytes at a time.  A 1-D grid of CTAs of 256 threads
// covers the n*q queries, 4 consecutive queries of one env a thread; no
// CTA is tied to an env, so none runs ragged at an env's end.  A thread
// issues all its index loads, then all 4 image loads, before it uses any
// of them, then rounds and stores.  The vector path reads its 4 queries'
// indices as one int4 of each array and writes one float4; it needs
// q % 4 == 0, so that no vector straddles two envs, and 16-byte aligned
// arrays.  The scalar path takes every other layout (a ragged q, a
// contiguous view one int32 into its buffer): 4 single queries a thread,
// 32 apart, so that a warp's loads of one round stay contiguous.  Both
// give the same bits; the wrapper (ops/gather.py::launch_geometry) picks
// the path from q and the pointers.  This geometry was chosen by timing
// on an H100 (PERF.md, section 6).
//
// Indices must be in range (the callers clip them); they are clamped here
// as well so that a bad index can never read outside the image.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kPerThread = 4;   // queries a thread
constexpr int kThreads = 256;   // threads a CTA

template <int W>
struct Vec;

template <>
struct Vec<1> {
  __device__ static void load(const int* p, int* x) { x[0] = __ldg(p); }
  __device__ static void store(float* p, const float* x) { p[0] = x[0]; }
};

template <>
struct Vec<4> {
  __device__ static void load(const int* p, int* x) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

// Vectors of W queries, nv of them in all, qv = q / W an env; a thread
// takes K = 4 / W of them, and the thread at lane l of warp g takes
// vectors g * 32K + l + 32j for j < K.
template <int W>
__global__ void __launch_bounds__(kThreads) gather_image_kernel(
    const float* __restrict__ img, const int* __restrict__ vi,
    const int* __restrict__ ui, float* __restrict__ out, unsigned nv,
    unsigned qv, int h, int w) {
  constexpr int K = kPerThread / W;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const unsigned first = warp * (32 * K) + (threadIdx.x & 31);
  int v[K][W], u[K][W];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const unsigned g = first + 32 * j;
    if (g < nv) {
      Vec<W>::load(vi + static_cast<size_t>(g) * W, v[j]);
      Vec<W>::load(ui + static_cast<size_t>(g) * W, u[j]);
    }
  }
  float x[K][W];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const unsigned g = first + 32 * j;
    if (g < nv) {
      const float* __restrict__ im =
          img + static_cast<size_t>(g / qv) * static_cast<size_t>(h) * w;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int r = min(max(v[j][i], 0), h - 1);
        const int c = min(max(u[j][i], 0), w - 1);
        x[j][i] = __ldg(im + r * w + c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const unsigned g = first + 32 * j;
    if (g < nv) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        x[j][i] = __bfloat162float(__float2bfloat16_rn(x[j][i]));
      Vec<W>::store(out + static_cast<size_t>(g) * W, x[j]);
    }
  }
}

template <int W>
void launch(const float* img, const int* vi, const int* ui, float* out,
            int n, int q, int h, int w, cudaStream_t stream) {
  const unsigned nv = static_cast<unsigned>(n) * static_cast<unsigned>(q) / W;
  constexpr unsigned per_cta = kThreads * kPerThread / W;
  gather_image_kernel<W><<<(nv + per_cta - 1) / per_cta, kThreads, 0, stream>>>(
      img, vi, ui, out, nv, static_cast<unsigned>(q / W), h, w);
}

}  // namespace

// img [n, h, w] float32, vi/ui [n, q] int32, out [n, q] float32, all
// contiguous on the current device, n * q and h * w below 2^31.  `width`
// is the path: 4 (vectors; q % 4 == 0 and vi, ui and out 16-byte aligned)
// or 1 (single queries).  Launches once on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// or a layout it does not take; it does not synchronise.
extern "C" int gather_image(const float* img, const int* vi, const int* ui,
                            float* out, int n, int q, int h, int w, int width,
                            void* stream) {
  if (n < 0 || q < 0 || h <= 0 || w <= 0 ||
      static_cast<long long>(n) * q > INT_MAX ||
      static_cast<long long>(h) * w > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || q == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4) {
    if (q % 4 != 0 ||
        (reinterpret_cast<uintptr_t>(vi) | reinterpret_cast<uintptr_t>(ui) |
         reinterpret_cast<uintptr_t>(out)) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    launch<4>(img, vi, ui, out, n, q, h, w, s);
  } else if (width == 1) {
    launch<1>(img, vi, ui, out, n, q, h, w, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
