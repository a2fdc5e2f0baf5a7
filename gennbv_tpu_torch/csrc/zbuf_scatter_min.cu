// Batched exact scatter-min z-buffer, for Hopper (sm_90a): one launch of one
// kernel, persistent CTAs walking (env, band of image rows) items, each band
// built in shared memory.
//
//   out[n, p] = min(fill, min{ zz[n, i] : flat[n, i] == p })
//
// for every pixel p in [0, H*W) of every env n.  This is the JAX package's
// exact z-buffer (gennbv_tpu/ops/splat.py::_zbuf_px, zbuf_impl="scatter":
// zbuf.at[flat].min(where(ok, z, depth_max))).
//
// Replaces the TPU kernel tools/bench_scatter.py:93 zbuf_kernel (launched
// by zbuf_pallas through pl.pallas_call), whose grid walks the envs one
// after another, holds one env's whole (cam, cam) image in VMEM filled with
// the fill value, and min-updates it point by point in a scalar loop.  A
// CTA has at most 227 KB of shared memory, so the image is cut into bands
// of rows, and a band's points are applied with shared-memory atomics
// instead of one after another.
//
// What bounds it on an H100: memory, most of it the image's writes.  The
// least traffic is each point's pixel index and depth read once (8 B) and
// the image written once (4 B a pixel); at the eval's shapes (50 envs,
// Q = 9216, 400x400) that is 3.7 MB + 32 MB, ~10.7 us at 3.35 TB/s, at the
// rollout's (256 envs, Q = 11264, 128x128) 23.1 MB + 16.8 MB, ~11.9 us.
// Each band also reads all its env's indices and depths (a band cannot
// know which points fall in it), from L2 after the first band.  A one-shot
// grid of one CTA a band leaves a second, short wave at 400x400 (300 CTAs
// for 264 slots), and a CTA writes nothing until its band is built; so
// here:
//   - the grid is persistent: at most one CTA an SM (the wrapper reads the
//     SM count), walking the items env-major with a static stride, so the
//     CTAs on one env's bands run side by side and its points come from L2
//     after the first read; no counter, no second launch;
//   - the CTA's two halves of 512 threads are two lanes, each with its own
//     band buffer of keys in dynamic shared memory, its own named barrier
//     (bar.sync) and its own items (CTA c's lane l takes items c + l *
//     grid, then every 2 * grid on), so two bands are built at once and
//     one lane's scan overlaps the other's fill and stores, as two CTAs an
//     SM would; unlike two CTAs, an SM's items are fixed by the stride and
//     not by where the hardware puts each CTA;
//   - the band geometry (ops/zbuf_scatter.py::geometry) is chosen in
//     Python from the shapes and the SM count, among the band heights
//     whose two buffers fit one CTA;
//   - for each item a lane takes: 1. a barrier of the lane (its threads
//     are done with the buffer); 2. the band's keys start at the fill's
//     key; barrier; 3. the lane's threads stride over all Q of the env's
//     points, in 16-byte vectors of indices and of depths where the env's
//     arrays are 16-byte aligned (kVecBatch vectors, 4 points each, a
//     thread at once), the rest one by one (kBatch at once), every load of
//     a batch issued before any is used, and each point that falls in the
//     band and lies below the fill takes an atomicMin into its pixel's
//     key; barrier; 4. the threads decode the band and store it,
//     neighbouring threads on neighbouring pixels.
// A form that builds each band with the whole CTA and writes it out by a
// TMA bulk store (cp.async.bulk) from one of two buffers in turn, while
// the next band is built in the other, measured slower at every band
// height and CTA count tried, at both paths' shapes (PERF.md, section 6):
// a bulk store starts only once its whole band is decoded, and the band
// passes through shared memory twice more, where plain stores leave as
// each pixel is decoded.
//
// The min is order-free, so the result does not depend on the order of
// the atomics: it is deterministic and equal bit for bit to a sequential
// min.  The key is the float's bits, order-preserving as unsigned: a
// sign-clear float gets its top bit set, a sign-set float is inverted.  So
// every negative float orders below every positive one, larger magnitudes
// below smaller among negatives, and -0.0 (key 0x7fffffff) orders just
// below +0.0 (0x80000000): a pixel that gets both zeros holds -0.0.  NaN
// is not an input (the env's depths are finite: beyond a 1e-3 near plane,
// or the fill).  Pixel indices must be in [0, H*W); a point outside falls
// in no band and is dropped, so a bad index can never write outside its
// image.
#include <cuda_runtime.h>
#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 2;        // items a CTA builds at once, a buffer each
constexpr int kLaneThreads = kThreads / kLanes;
constexpr int kBatch = 8;        // points a thread loads at once, one by one
constexpr int kVecBatch = 3;     // or 16-byte vectors of 4 points
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One point of the scan: where pixel `p` falls in the band [lo, lo + count)
// and `depth` lies below the fill, an atomicMin of its key into the
// pixel's (skipped where the key already holds no more than it: keys only
// fall, so a stale read is never too low).  A pixel below lo wraps to a
// large unsigned and falls in no band.
__device__ __forceinline__ void take(unsigned* keys, int p, float depth,
                                     int lo, int count, unsigned fill_key) {
  const unsigned i = static_cast<unsigned>(p) - static_cast<unsigned>(lo);
  if (i < static_cast<unsigned>(count)) {
    const unsigned k = key_of(depth);
    if (k < fill_key && k < keys[i]) atomicMin(keys + i, k);
  }
}

// A barrier of one lane's threads: named barrier 1 + lane.
__device__ __forceinline__ void lane_sync(int lane) {
  asm volatile("bar.sync %0, %1;" :: "r"(lane + 1), "n"(kLaneThreads)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
zbuf_scatter_min_kernel(const int* __restrict__ flat,
                        const float* __restrict__ zz, float* __restrict__ out,
                        int q, int hw, int band_pixels, int bands, int items,
                        float fill) {
  extern __shared__ unsigned smem[];             // [kLanes][band_pixels]
  const int lane = threadIdx.x / kLaneThreads;
  const int t = threadIdx.x % kLaneThreads;       // the thread in its lane
  unsigned* keys = smem + lane * band_pixels;     // keys[i] is pixel lo + i
  const unsigned fill_key = key_of(fill);
  for (long long item = blockIdx.x + static_cast<long long>(lane) * gridDim.x;
       item < items; item += static_cast<long long>(kLanes) * gridDim.x) {
    const long long env = item / bands;
    // the band's first pixel
    const int lo = static_cast<int>(item % bands) * band_pixels;
    const int count = min(band_pixels, hw - lo);
    float* dst = out + env * hw + lo;

    // 1. the buffer is free: the lane's threads have stored the last item
    lane_sync(lane);

    // 2. the band starts at the fill
    for (int i = t; i < count; i += kLaneThreads) keys[i] = fill_key;
    lane_sync(lane);

    // 3. every point of the env below the fill that falls in the band: in
    //    16-byte vectors of 4 where the env's indices and depths are
    //    16-byte aligned, then (or else) one by one
    const int* f = flat + env * q;
    const float* z = zz + env * q;
    int scanned = 0;                              // points the vectors took
    if (((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(z)) &
         15) == 0) {
      const int q4 = q / 4;
      const int4* f4 = reinterpret_cast<const int4*>(f);
      const float4* z4 = reinterpret_cast<const float4*>(z);
      for (int base = t; base < q4; base += kVecBatch * kLaneThreads) {
        int4 pix[kVecBatch];
        float4 depth[kVecBatch];
#pragma unroll
        for (int j = 0; j < kVecBatch; ++j) {
          const int i = base + j * kLaneThreads;
          pix[j] = i < q4 ? __ldg(f4 + i) : make_int4(-1, -1, -1, -1);
          depth[j] = i < q4 ? __ldg(z4 + i) : make_float4(fill, fill, fill,
                                                          fill);
        }
#pragma unroll
        for (int j = 0; j < kVecBatch; ++j) {
          take(keys, pix[j].x, depth[j].x, lo, count, fill_key);
          take(keys, pix[j].y, depth[j].y, lo, count, fill_key);
          take(keys, pix[j].z, depth[j].z, lo, count, fill_key);
          take(keys, pix[j].w, depth[j].w, lo, count, fill_key);
        }
      }
      scanned = q4 * 4;
    }
    for (int base = scanned + t; base < q; base += kBatch * kLaneThreads) {
      int pix[kBatch];
      float depth[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kLaneThreads;
        pix[j] = i < q ? __ldg(f + i) : -1;
        depth[j] = i < q ? __ldg(z + i) : fill;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        take(keys, pix[j], depth[j], lo, count, fill_key);
    }
    lane_sync(lane);

    // 4. decoded and stored
    for (int i = t; i < count; i += kLaneThreads) dst[i] = float_of(keys[i]);
  }
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
// bands of `band_pixels` pixels (the last may be shorter); min(ctas,
// n * bands) CTAs walk the n * bands items, each with two band buffers of
// band_pixels keys (4 B each) of dynamic shared memory.  Launches the
// kernel once on `stream` and returns cudaGetLastError() (0 on success);
// buffers too large for a CTA's shared memory are an error.  It does not
// synchronise.
extern "C" int zbuf_scatter_min(const int* flat, const float* zz, float* out,
                                int n, int q, int hw, int band_pixels,
                                int bands, int ctas, float fill,
                                void* stream) {
  if (n <= 0 || q < 0 || hw <= 0 || band_pixels <= 0 || bands <= 0 ||
      ctas <= 0 || static_cast<long long>(bands) * band_pixels < hw ||
      static_cast<long long>(bands - 1) * band_pixels >= hw ||
      static_cast<long long>(n) * bands > INT_MAX ||
      band_pixels > INT_MAX / kLanes / static_cast<int>(sizeof(unsigned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_full_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = n * bands;
  zbuf_scatter_min_kernel<<<std::min(ctas, items), kThreads,
                            static_cast<size_t>(kLanes) * band_pixels *
                                sizeof(unsigned),
                            static_cast<cudaStream_t>(stream)>>>(
      flat, zz, out, q, hw, band_pixels, bands, items, fill);
  return static_cast<int>(cudaGetLastError());
}
