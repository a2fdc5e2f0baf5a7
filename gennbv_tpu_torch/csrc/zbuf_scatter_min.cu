// Batched exact scatter-min z-buffer, for Hopper (sm_90a): one launch of one
// kernel, one CTA per (env, band of image rows), the band in shared memory.
//
//   out[n, p] = min(fill, min{ zz[n, i] : flat[n, i] == p })
//
// for every pixel p in [0, H*W) of every env n.  This is the JAX package's
// exact z-buffer (gennbv_tpu/ops/splat.py::_zbuf_px, zbuf_impl="scatter":
// zbuf.at[flat].min(where(ok, z, depth_max))).
//
// Replaces the TPU kernel tools/bench_scatter.py::zbuf_kernel (launched by
// zbuf_pallas through pl.pallas_call), whose grid walks the envs one after
// another, holds one env's whole (cam, cam) image in VMEM filled with the
// fill value, and min-updates it point by point in a scalar loop.  A GPU
// runs CTAs in parallel and has at most 227 KB of shared memory a CTA, so
// the image is cut into bands of rows, a CTA each, and a band's points are
// applied with shared-memory atomics instead of one after another.
//
// What bounds it on an H100: memory.  The least traffic is each point's
// pixel index and depth read once (8 B) and the image written once (4 B a
// pixel); at the rollout's shapes (256 envs, Q = 11264, 128x128) that is
// 23.1 MB + 16.8 MB, ~11.9 us at 3.35 TB/s.  A CTA reads all its env's
// pixel indices (a band cannot know which points fall in it), so with B
// bands an env's indices are read B times, all but the first from L2; a
// point's depth is read only by the band it falls in.
//
// Layout.  CTA (env, band) holds the band's pixels as uint32 keys in
// dynamic shared memory:
//   1. the keys start at the fill's key; block barrier;
//   2. the CTA's threads stride over all Q of the env's points, kBatch at
//      once (all their indices and depths loaded before any is used), and
//      each point that falls in the band and lies below the fill takes an
//      atomicMin into its pixel's key (skipped where the key already holds
//      no more than it: keys only fall, so a stale read is never too low);
//      block barrier;
//   3. the band is decoded and written out, neighbouring threads on
//      neighbouring pixels.
// The min is order-free, so the result does not depend on the order of
// the atomics: it is deterministic and equal bit for bit to a sequential
// min.  Unlike the fused splat (zbuf_visible.cu) a scatter-min reads no
// neighbouring pixels, so bands share nothing and need no cluster.
//
// The key is the float's bits, order-preserving as unsigned: a sign-clear
// float gets its top bit set, a sign-set float is inverted.  So every
// negative float orders below every positive one, larger magnitudes below
// smaller among negatives, and -0.0 (key 0x7fffffff) orders just below
// +0.0 (0x80000000): a pixel that gets both zeros holds -0.0.  NaN is not
// an input (the env's depths are finite: beyond a 1e-3 near plane, or the
// fill).  Pixel indices must be in [0, H*W); a point outside falls in no
// band and is dropped, so a bad index can never write outside its image.
#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kBatch = 4;      // points a thread loads at once
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kThreads, 2)
zbuf_scatter_min_kernel(const int* __restrict__ flat,
                        const float* __restrict__ zz, float* __restrict__ out,
                        int q, int hw, int band_pixels, int bands,
                        float fill) {
  extern __shared__ unsigned keys[];                     // [band_pixels]
  const long long env = blockIdx.x / bands;
  const int lo = (blockIdx.x % bands) * band_pixels;    // the band's first pixel
  const int count = min(band_pixels, hw - lo);
  const unsigned fill_key = key_of(fill);

  // 1. the band starts at the fill
  for (int i = threadIdx.x; i < count; i += kThreads) keys[i] = fill_key;
  __syncthreads();

  // 2. every point of the env below the fill that falls in the band
  const int* f = flat + env * q;
  const float* z = zz + env * q;
  for (int base = threadIdx.x; base < q; base += kBatch * kThreads) {
    unsigned pix[kBatch];
    float depth[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads;
      // an index below lo wraps to a large unsigned and falls in no band
      pix[j] = i < q ? static_cast<unsigned>(__ldg(f + i)) -
                           static_cast<unsigned>(lo)
                     : UINT_MAX;
      depth[j] = i < q ? __ldg(z + i) : fill;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (pix[j] < static_cast<unsigned>(count)) {
        const unsigned k = key_of(depth[j]);
        if (k < fill_key && k < keys[pix[j]]) atomicMin(keys + pix[j], k);
      }
    }
  }
  __syncthreads();

  // 3. the band out, decoded
  float* o = out + env * hw + lo;
  for (int i = threadIdx.x; i < count; i += kThreads) o[i] = float_of(keys[i]);
}

// Lets the kernel take all the dynamic shared memory a CTA may have on the
// current device, once per device (the attribute is per device), so that
// every launch after the first is the launch alone.
cudaError_t allow_full_shared_memory() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, zbuf_scatter_min_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(zbuf_scatter_min_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// flat [n, q] int32 pixel indices in [0, hw), zz [n, q] float32, out [n, hw]
// float32 (written in full: it need not be initialised), all contiguous on
// the current device; n > 0.  The image of each env is cut into `bands`
// bands of `band_pixels` pixels (the last may be shorter), one CTA each,
// with band_pixels * 4 bytes of dynamic shared memory.  Launches the kernel
// once on `stream` and returns cudaGetLastError() (0 on success); a band
// too large for a CTA's shared memory is an error.  It does not
// synchronise.
extern "C" int zbuf_scatter_min(const int* flat, const float* zz, float* out,
                                int n, int q, int hw, int band_pixels,
                                int bands, float fill, void* stream) {
  if (n <= 0 || q < 0 || hw <= 0 || band_pixels <= 0 || bands <= 0 ||
      static_cast<long long>(bands) * band_pixels < hw ||
      static_cast<long long>(bands - 1) * band_pixels >= hw ||
      static_cast<long long>(n) * bands > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_full_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  zbuf_scatter_min_kernel<<<n * bands, kThreads,
                            static_cast<size_t>(band_pixels) * sizeof(unsigned),
                            static_cast<cudaStream_t>(stream)>>>(
      flat, zz, out, q, hw, band_pixels, bands, fill);
  return static_cast<int>(cudaGetLastError());
}
