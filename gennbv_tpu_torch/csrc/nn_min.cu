// Brute-force nearest-neighbour minima of the report's accuracy passes
// (scan to GT, GT to scan, GT to GT without self), batched over envs, for
// Hopper (sm_90a): one launch of one kernel a pass.
//
// For every env e and query row i of a[e] with a_mask[e, i] set:
//   out[e, i] = min over the targets j of b[e] with b_mask[e, j] set (and,
//               with exclude_self, j != i) of |a[e, i] - b[e, j]|^2,
// 1e10 where the query is masked out or no target counts.  This is
// ops/chamfer.py's _row_mins (the plain loop) and the JAX package's
// gennbv_tpu/ops/chamfer.py (plain jnp over [chunk, Q] tiles: there is no
// TPU kernel of it).  The plain loop builds each [chunk, Q] tile of squared
// distances in device memory out of elementwise kernels whose fused
// multiply-adds are emulated in float64, ~40 bytes a pair; here each pair
// lives in registers and nothing but the minima is written.
//
// Rounding follows the plain loop bit for bit.  Every float operation is
// an explicit round-to-nearest intrinsic, so that nvcc's contraction
// cannot move an ulp: per pair d_k = a_k - b_k, then d0 * d0, then
// fma(d1, d1, .) and fma(d2, d2, .) (the FMA chain XLA's CPU compiler
// makes of sum((a - b) ** 2)), then the min.  The plain loop's
// ops/fp32.py::fma rounds a float64 sum to float32: the float32 product
// is exact in float64, and with both summands non-negative the float64
// sum is exact unless the product's last bit lies 53 below the sum's
// first, so the two round alike but where that float64 rounding lands on
// a float32 midpoint; the card tests hold the kernel bit-equal to the
// plain loop over random and eval-sized clouds.  No tensor cores and no
// |a|^2 + |b|^2 - 2 a.b: that form rounds relative to |a|^2, not to the
// distance.
//
// What bounds it on an H100: instructions.  A pair is 7 of them (three
// subtractions, a product, two FMAs, a min), all on the CUDA cores at 128
// lanes a clock an SM; the report's ~4.0e9 pairs an episode are ~0.84 ms
// of issue at 1.98 GHz.  So the design keeps everything else off the
// issue slots:
//   - a CTA takes 256 query rows of one env, two a thread, in registers;
//   - its env's targets are staged 1,024 at a time in shared memory as
//     x, y and z arrays, and each thread reads four targets' coordinates
//     with three 16-byte loads that every lane of a warp shares (a
//     broadcast, no bank conflicts): 0.375 loads a pair;
//   - a masked-out target, and the tail past the env's last valid one,
//     is staged as NaN: fminf(acc, NaN) is acc, so the masks cost nothing
//     in the inner loop;
//   - only the 256 targets that share the CTA's row indices take the
//     exclude_self compare;
//   - each CTA finds its env's target extent (the first index past its
//     last valid target) itself and computes targets only up to it,
//     rounded up to 4; a CTA whose rows hold no valid query writes 1e10
//     and stops, and a warp whose 64 rows hold none joins the staging but
//     computes nothing.
// No atomics and no reduction across CTAs: a CTA owns its rows' minima.
// Of the geometries timed at the report's shapes on an H100 (1, 2 or 4
// rows a thread, 64 to 256 threads a CTA, tiles of 512 to 2,048 targets,
// the target loop unrolled 2 to 8 groups deep; 1.38 to 1.75 ms for the
// three passes, ~4.0e9 pairs), this one is among the fastest, at 1.39 ms:
// more rows a thread halve the shared loads but leave fewer CTAs to even
// out the envs' unequal target counts over the SMs.
// The pairs computed, which ops/nn_min.py::pairs counts from the host's
// masks, are each env's active warps' 64 rows times its target extent
// rounded up to 4: every pair of the brute force, no index, no symmetry.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                        // a CTA's threads
constexpr int kRowsPerThread = 2;
constexpr int kWarpRows = 32 * kRowsPerThread;       // 64
constexpr int kRows = kThreads * kRowsPerThread;     // a CTA's 256 rows
constexpr int kTile = 1024;                          // targets a stage
constexpr int kGroup = 4;                            // targets a read
constexpr int kMaxGridY = 65535;
constexpr float kBig = 1e10f;

// one past the last nonzero byte of mask[0, q), for every thread of the
// CTA; `scratch` holds a value a warp
__device__ int mask_extent(const unsigned char* __restrict__ mask, int q,
                           int* scratch) {
  int last = 0;
  if ((q & 15) == 0 && (reinterpret_cast<size_t>(mask) & 15) == 0) {
    const uint4* words = reinterpret_cast<const uint4*>(mask);
    for (int i = threadIdx.x; i < q / 16; i += kThreads) {
      const uint4 w = __ldg(words + i);
      // the highest nonzero 32-bit word of the 16 bytes, then its highest
      // nonzero byte (little-endian: byte k holds bits 8k to 8k + 7)
      const int k = w.w ? 3 : (w.z ? 2 : (w.y ? 1 : (w.x ? 0 : -1)));
      if (k >= 0) {
        const unsigned v = k == 3 ? w.w : (k == 2 ? w.z : (k == 1 ? w.y : w.x));
        last = 16 * i + 4 * k + (31 - __clz(v)) / 8 + 1;
      }
    }
  } else {
    for (int j = threadIdx.x; j < q; j += kThreads)
      if (__ldg(mask + j)) last = j + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = last;
  __syncthreads();
  int ext = scratch[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) ext = max(ext, scratch[w]);
  return ext;
}

// the pairs of this thread's rows with the staged targets [j0, j1) (j0,
// j1 multiples of 4; `first` is the tile's first target index): each
// row's running minimum; kSelf skips the target whose index is the row's
template <bool kSelf>
__device__ __forceinline__ void run_pairs(
    const float* sx, const float* sy, const float* sz, int j0, int j1,
    int first, const float (&qx)[kRowsPerThread],
    const float (&qy)[kRowsPerThread], const float (&qz)[kRowsPerThread],
    const int (&row)[kRowsPerThread], float (&acc)[kRowsPerThread]) {
#pragma unroll 4
  for (int j = j0; j < j1; j += kGroup) {
    const float4 x4 = *reinterpret_cast<const float4*>(sx + j);
    const float4 y4 = *reinterpret_cast<const float4*>(sy + j);
    const float4 z4 = *reinterpret_cast<const float4*>(sz + j);
    const float bx[kGroup] = {x4.x, x4.y, x4.z, x4.w};
    const float by[kGroup] = {y4.x, y4.y, y4.z, y4.w};
    const float bz[kGroup] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const float d0 = __fsub_rn(qx[k], bx[t]);
        const float d1 = __fsub_rn(qy[k], by[t]);
        const float d2 = __fsub_rn(qz[k], bz[t]);
        float s = __fmul_rn(d0, d0);
        s = __fmaf_rn(d1, d1, s);
        s = __fmaf_rn(d2, d2, s);
        if (kSelf && first + j + t == row[k]) continue;
        acc[k] = fminf(acc[k], s);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    nn_min_kernel(const float* __restrict__ a,
                  const unsigned char* __restrict__ a_mask,
                  const float* __restrict__ b,
                  const unsigned char* __restrict__ b_mask,
                  float* __restrict__ out, int n, int p, int q,
                  int exclude_self) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ __align__(16) float sz[kTile];
  __shared__ int scratch[kThreads / 32];
  const float missing = __int_as_float(0x7fc00000);  // a NaN
  const int lane = threadIdx.x & 31;
  const int cta_row = blockIdx.x * kRows;
  for (int env = blockIdx.y; env < n; env += gridDim.y) {
    const long long a_env = static_cast<long long>(env) * p;
    const long long b_env = static_cast<long long>(env) * q;
    // rows cta_row + 64 w + 32 k + lane: a warp's 64 rows are contiguous
    float qx[kRowsPerThread], qy[kRowsPerThread], qz[kRowsPerThread];
    float acc[kRowsPerThread];
    int row[kRowsPerThread];
    bool valid[kRowsPerThread];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      row[k] = cta_row + (threadIdx.x >> 5) * kWarpRows + 32 * k + lane;
      valid[k] = row[k] < p && a_mask[a_env + row[k]];
      const float* pt = a + 3 * (a_env + row[k]);
      qx[k] = valid[k] ? pt[0] : 0.f;
      qy[k] = valid[k] ? pt[1] : 0.f;
      qz[k] = valid[k] ? pt[2] : 0.f;
      acc[k] = kBig;
      any |= valid[k];
    }
    const bool warp_active = __any_sync(0xffffffffu, any);
    if (__syncthreads_or(any)) {
      const int ext = mask_extent(b_mask + b_env, q, scratch);
      const int end = (ext + kGroup - 1) / kGroup * kGroup;
      for (int t0 = 0; t0 < end; t0 += kTile) {
        const int tn = min(kTile, end - t0);
        __syncthreads();  // the last tile's reads (and the scratch's) done
        for (int j = threadIdx.x; j < tn; j += kThreads) {
          const int g = t0 + j;
          const bool ok = g < ext && b_mask[b_env + g];
          const float* pt = b + 3 * (b_env + g);
          sx[j] = ok ? pt[0] : missing;
          sy[j] = ok ? pt[1] : missing;
          sz[j] = ok ? pt[2] : missing;
        }
        __syncthreads();
        if (!warp_active) continue;
        // the tile's targets that share the CTA's row indices, [lo, hi)
        const int lo = max(cta_row - t0, 0);
        const int hi = min(cta_row + kRows - t0, tn);
        if (exclude_self && lo < hi) {
          run_pairs<false>(sx, sy, sz, 0, lo, t0, qx, qy, qz, row, acc);
          run_pairs<true>(sx, sy, sz, lo, hi, t0, qx, qy, qz, row, acc);
          run_pairs<false>(sx, sy, sz, hi, tn, t0, qx, qy, qz, row, acc);
        } else {
          run_pairs<false>(sx, sy, sz, 0, tn, t0, qx, qy, qz, row, acc);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
      if (row[k] < p) out[a_env + row[k]] = valid[k] ? acc[k] : kBig;
    __syncthreads();  // the scratch and the tiles free for the next env
  }
}

}  // namespace

// a [n, p, 3] and b [n, q, 3] float32, a_mask [n, p] and b_mask [n, q]
// uint8 (nonzero: valid), out [n, p] float32 (written in full), all
// contiguous on the current device; points finite.  Launches the kernel
// once on `stream` and returns cudaGetLastError() (0 on success).  It does
// not synchronise.
extern "C" int nn_min(const float* a, const unsigned char* a_mask,
                      const float* b, const unsigned char* b_mask, float* out,
                      int n, int p, int q, int exclude_self, void* stream) {
  if (n <= 0 || p <= 0 || q < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((p + kRows - 1) / kRows, n < kMaxGridY ? n : kMaxGridY);
  nn_min_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, a_mask, b, b_mask, out, n, p, q, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
