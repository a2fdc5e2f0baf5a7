// Fused splat z-buffer + per-point visibility, batched over envs, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gennbv_tpu/ops/pallas_splat.py::_splat_kernel
// (with its helpers _minpool_same and _decode_digit, called through
// pallas_splat.zbuf_visible).  Per env, from projected points (pixel row
// vi, column ui, depth z, validity ok):
//   1. the z range of the valid points: zmin, zrange = max(zmax - zmin, 1e-3);
//   2. each valid point's depth bucket as two decimal digits d1, d2 of
//      t = clamp((z - zmin) / zrange * 10, 0, 10 - 1e-3), and the per-pixel
//      minimum of key = d1 * 10 + d2 (100 where no valid point lands);
//   3. the key decoded to its bucket's midpoint
//      zmin + (d1 + (d2 + 0.5) / 10) * zrange / 10, min-pooled over the
//      (2f+1)^2 footprint with depth_max beyond the image and where no point
//      lands, and never above depth_max (f > 0);
//   4. visibility: z <= bf16(pooled z-buffer at the point's pixel)
//      + voxel_eps + zrange / 100.
// The TPU kernel takes the minimum as two radix passes of exponent-encoded
// one-hot products on its matrix unit and skips 512-point chunks with no
// valid point.  Here the minimum is an integer atomicMin on the key, which
// is exact for any number of points per pixel, and a thread whose point is
// not valid returns at once; outputs stay in point order, so nothing is
// sorted.
//
// Rounding follows the plain PyTorch version (ops/fused_splat.py, the
// composition in ops/splat.py) bit for bit.  Every float operation is
// written as an explicit round-to-nearest intrinsic, so that nvcc's default
// contraction of a * b + c into one FMA cannot change an ulp (an ulp moves
// a bucket): the digit division is IEEE division, "/ 10" and "/ 100" are
// products with the float32 reciprocals (as XLA compiles them in the JAX
// reference), and zmin + frac * step is a float64 product-sum rounded once
// to float32 (ops/fp32.py::fma).  Decoding is monotone in the key, so the
// pool takes the minimum of the keys and decodes once.
//
// Four launches, each bound by memory (a few integer and float operations
// per element):
//   zrange_kernel   one block per env; reads the env's z and ok once (5 B
//                   per point); also fills the env's key image with 100
//                   (4 B per pixel written).
//   key_kernel      one thread per point; reads 13 B, then one atomicMin on
//                   a random 4-byte key.  At 400x400 an env's key image is
//                   640 KB; 50 envs' images (32 MB) fit the 50 MB L2, but
//                   not beside their 32 MB of z-buffers.
//   pool_kernel     one thread per pixel; reads the (2f+1)^2 keys around it
//                   (neighbouring threads share them through L1/L2) and
//                   writes the float32 z-buffer (4 B per pixel).
//   visible_kernel  one thread per point; reads 13 B and one random 4-byte
//                   z-buffer value, writes 1 B.
// No shared memory beyond the reduction's, and nothing for wgmma or TMA
// to do: the work is scattered, not tiled.
//
// Indices must be in range (the callers clip them); they are clamped here
// as well so that a bad index can never touch memory outside the image.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kLevels = 10;
constexpr int kEmptyKey = kLevels * kLevels;
constexpr int kThreads = 256;

__global__ void zrange_kernel(const float* __restrict__ z,
                              const uint8_t* __restrict__ ok,
                              float* __restrict__ zstat,
                              int* __restrict__ keys, int q, int hw) {
  const long long n = blockIdx.x;
  const float* zn = z + n * q;
  const uint8_t* okn = ok + n * q;
  float lo = __int_as_float(0x7f800000);    // +inf
  float hi = __int_as_float(0xff800000);    // -inf
  for (int k = threadIdx.x; k < q; k += blockDim.x) {
    if (__ldg(okn + k)) {
      const float v = __ldg(zn + k);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  int* kn = keys + n * hw;
  for (int k = threadIdx.x; k < hw; k += blockDim.x) kn[k] = kEmptyKey;

  __shared__ float s_lo[kThreads];
  __shared__ float s_hi[kThreads];
  s_lo[threadIdx.x] = lo;
  s_hi[threadIdx.x] = hi;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_lo[threadIdx.x] = fminf(s_lo[threadIdx.x], s_lo[threadIdx.x + s]);
      s_hi[threadIdx.x] = fmaxf(s_hi[threadIdx.x], s_hi[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // an env with no valid point: zmin = +inf, zrange = 1e-3
    zstat[2 * n] = s_lo[0];
    zstat[2 * n + 1] = fmaxf(__fsub_rn(s_hi[0], s_lo[0]),
                              static_cast<float>(1e-3));
  }
}

__global__ void key_kernel(const int* __restrict__ vi,
                           const int* __restrict__ ui,
                           const float* __restrict__ z,
                           const uint8_t* __restrict__ ok,
                           const float* __restrict__ zstat,
                           int* __restrict__ keys, int q, int h, int w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q) return;
  const long long n = blockIdx.y;
  const long long i = n * q + k;
  if (!__ldg(ok + i)) return;
  const float zmin = __ldg(zstat + 2 * n);
  const float zrange = __ldg(zstat + 2 * n + 1);
  float t = __fmul_rn(__fdiv_rn(__fsub_rn(__ldg(z + i), zmin), zrange),
                      static_cast<float>(kLevels));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(kLevels - 1e-3));
  const float d1 = floorf(t);
  const float d2 = floorf(__fmul_rn(__fsub_rn(t, d1),
                                    static_cast<float>(kLevels)));
  const int key = static_cast<int>(d1) * kLevels + static_cast<int>(d2);
  const int v = min(max(__ldg(vi + i), 0), h - 1);
  const int u = min(max(__ldg(ui + i), 0), w - 1);
  atomicMin(keys + n * h * w + v * w + u, key);
}

__global__ void pool_kernel(const int* __restrict__ keys,
                            const float* __restrict__ zstat,
                            float* __restrict__ zbuf, int h, int w,
                            int footprint, float depth_max) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  const long long n = blockIdx.y;
  const int* kn = keys + n * h * w;
  const int v = p / w;
  const int u = p - v * w;
  int kmin = kEmptyKey;
  for (int dv = max(v - footprint, 0); dv <= min(v + footprint, h - 1); ++dv)
    for (int du = max(u - footprint, 0); du <= min(u + footprint, w - 1); ++du)
      kmin = min(kmin, __ldg(kn + dv * w + du));
  float out = depth_max;
  if (kmin < kEmptyKey) {
    const float zmin = __ldg(zstat + 2 * n);
    const float zrange = __ldg(zstat + 2 * n + 1);
    const float m1 = static_cast<float>(kmin / kLevels);
    const float m2 = static_cast<float>(kmin % kLevels);
    const float tenth = 0.1f;              // float32 reciprocal of 10
    const float frac10 = __fadd_rn(m1, __fmul_rn(__fadd_rn(m2, 0.5f), tenth));
    const float step = __fmul_rn(zrange, tenth);
    const float zq = static_cast<float>(__dadd_rn(
        __dmul_rn(static_cast<double>(frac10), static_cast<double>(step)),
        static_cast<double>(zmin)));
    // the pool's window starts at depth_max, so a pooled depth never
    // exceeds it; without a footprint there is no pool
    out = footprint > 0 ? fminf(zq, depth_max) : zq;
  }
  zbuf[n * h * w + p] = out;
}

__global__ void visible_kernel(const int* __restrict__ vi,
                               const int* __restrict__ ui,
                               const float* __restrict__ z,
                               const uint8_t* __restrict__ ok,
                               const float* __restrict__ voxel_eps,
                               const float* __restrict__ zstat,
                               const float* __restrict__ zbuf,
                               uint8_t* __restrict__ visible,
                               int q, int h, int w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q) return;
  const long long n = blockIdx.y;
  const long long i = n * q + k;
  if (!__ldg(ok + i)) {
    visible[i] = 0;
    return;
  }
  const int v = min(max(__ldg(vi + i), 0), h - 1);
  const int u = min(max(__ldg(ui + i), 0), w - 1);
  const float zpx = __bfloat162float(
      __float2bfloat16_rn(__ldg(zbuf + n * h * w + v * w + u)));
  const float hundredth = 0.01f;           // float32 reciprocal of 100
  const float eps = __fadd_rn(__ldg(voxel_eps + n),
                              __fmul_rn(__ldg(zstat + 2 * n + 1), hundredth));
  visible[i] = __ldg(z + i) <= __fadd_rn(zpx, eps) ? 1 : 0;
}

}  // namespace

// vi, ui [n, q] int32 (in range), z [n, q] float32, ok [n, q] bool (one
// byte each), voxel_eps [n] float32; outputs zbuf [n, h * w] float32 and
// visible [n, q] bool; scratch zstat [n, 2] float32 and keys [n, h * w]
// int32.  All contiguous on the current device.  Launches the four kernels
// in order on `stream` and returns the first non-zero cudaGetLastError()
// (0 on success); it does not synchronise.
extern "C" int zbuf_visible(const int* vi, const int* ui, const float* z,
                            const uint8_t* ok, const float* voxel_eps,
                            float* zbuf, uint8_t* visible, float* zstat,
                            int* keys, int n, int q, int h, int w,
                            int footprint, float depth_max, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  zrange_kernel<<<n, kThreads, 0, s>>>(z, ok, zstat, keys, q, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q > 0) {
    const dim3 pts((q + kThreads - 1) / kThreads, n);
    key_kernel<<<pts, kThreads, 0, s>>>(vi, ui, z, ok, zstat, keys, q, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 pix((hw + kThreads - 1) / kThreads, n);
  pool_kernel<<<pix, kThreads, 0, s>>>(keys, zstat, zbuf, h, w, footprint,
                                       depth_max);
  err = cudaGetLastError();
  if (err != cudaSuccess || q == 0) return static_cast<int>(err);
  const dim3 pts((q + kThreads - 1) / kThreads, n);
  visible_kernel<<<pts, kThreads, 0, s>>>(vi, ui, z, ok, voxel_eps, zstat,
                                          zbuf, visible, q, h, w);
  return static_cast<int>(cudaGetLastError());
}
