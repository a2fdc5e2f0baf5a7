// Voxel DDA ray march (Amanatides and Woo, "A Fast Voxel Traversal
// Algorithm for Ray Tracing", Eurographics 1987), batched over envs, for
// Hopper (sm_90a): one launch of one kernel, one thread a ray.
//
// For every ray p of every env n, from origin[n] along dirs[n, p] through
// the env's dense occupancy grid occ[n] of R^3 one-byte voxels (nonzero is
// solid) spanning [box_lo[n], box_hi[n]]:
//   depth[n, p] = min(t, depth_max) at the first solid voxel the ray
//                 enters within max_steps voxels, depth_max where none;
//   hit[n, p]   = whether it found one.
// This is the plain loop of ops/render.py (raymarch_ref) and of the JAX
// package (gennbv_tpu/ops/render.py::raymarch, an XLA while loop: there is
// no TPU kernel of it).  That loop steps every ray of the batch together,
// dead rays included, for as many iterations as the longest ray needs, and
// moves every ray's state through device memory at each of ~25 launches an
// iteration.  Here each thread holds its ray's state in registers, reads
// each voxel on its path once, and stops at its own end: its first solid
// voxel, its exit from the grid, or max_steps voxels.
//
// Rounding follows the plain loop bit for bit (its depths are compared
// exactly).  Every float operation is an explicit round-to-nearest
// intrinsic, so that nvcc's default contraction of a * b + c into an FMA
// cannot move an ulp:
//   - vsize = (hi - lo) * rcp(R), a product with the float32 reciprocal
//     (ops/fp32.py::div_const);
//   - a direction component with |d| < 1e-9 is 1e-9, inv_d = 1 / d;
//   - the slab test t0 = (lo - o) * inv_d, t1 = (hi - o) * inv_d,
//     t_enter = max(max_a min(t0, t1), 1e-3), t_far = min_a max(t0, t1);
//     a ray with t_far <= t_enter reads no voxel;
//   - the entry point o + d * (t_enter + 1e-5) and the first boundary
//     lo + (voxel + ahead) * vsize are float64 product-sums rounded once
//     to float32, as ops/fp32.py::fma rounds them (the float32 product is
//     exact in float64; a float32 fmaf differs where double rounding
//     bites);
//   - the entry voxel floor((p - lo) / vsize) clamped to [0, R - 1] as a
//     float; the step's sign is that of the unguarded direction (>= 0 is
//     +1);
//   - the axis of the smallest t_max, the lowest on ties (x, then y, then
//     z), and t_max + t_delta on it; the plain loop adds 0 to the other two
//     (turning a -0 into +0), and so does this kernel.
//
// What bounds it on an H100: the voxel reads' latency.  Each thread's loop
// is a dependent chain (read a byte, compare, step), ~10 instructions a
// voxel; the grids (262 KB an env at R = 64, 13 MB for 50 envs) stay in L2
// and the neighbouring rays of a warp read neighbouring voxels, so the
// reads hit L1 or L2.  A warp runs as long as its longest ray; consecutive
// threads take consecutive pixels of one env (a row segment of the image),
// whose rays end near one another except at silhouettes.
//
// The voxels read, summed over the rays (the benchmark's own count of the
// march's work), are added to *reads where reads is not null: a warp sums
// its rays' counts with a warp reduction and one lane adds the sum with
// one 64-bit atomic.  The wrapper passes a counter only while spans record
// or the work is counted, so an untimed call does no atomics.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;  // a CTA's threads

// a * b + c rounded once to float32 as ops/fp32.py::fma rounds it
__device__ __forceinline__ float fma_via_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// the loop's guarded direction component: |d| < 1e-9 becomes 1e-9
__device__ __forceinline__ float guarded(float d) {
  return fabsf(d) < 1e-9f ? 1e-9f : d;
}

__global__ void __launch_bounds__(kThreads)
    raymarch_kernel(const unsigned char* __restrict__ occ,
                    const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi,
                    const float* __restrict__ origin,
                    const float* __restrict__ dirs,
                    float* __restrict__ depth, unsigned char* __restrict__ hit,
                    unsigned long long* __restrict__ reads, long long rays,
                    int p, int r, int max_steps, float depth_max) {
  const long long ray = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  unsigned count = 0;
  if (ray < rays) {
    const int env = static_cast<int>(ray / p);
    const float* d3 = dirs + 3 * ray;
    const float rcp_r = __frcp_rn(static_cast<float>(r));
    float lo[3], vsize[3], org[3], inv[3];
    float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = box_lo[3 * env + a];
      const float hi = box_hi[3 * env + a];
      org[a] = origin[3 * env + a];
      vsize[a] = __fmul_rn(__fsub_rn(hi, lo[a]), rcp_r);
      inv[a] = __frcp_rn(guarded(d3[a]));
      const float t0 = __fmul_rn(__fsub_rn(lo[a], org[a]), inv[a]);
      const float t1 = __fmul_rn(__fsub_rn(hi, org[a]), inv[a]);
      t_near = fmaxf(t_near, fminf(t0, t1));
      t_far = fminf(t_far, fmaxf(t0, t1));
    }
    const float t_enter = fmaxf(t_near, 1e-3f);
    bool found = false;
    float t_hit = depth_max;
    if (t_far > t_enter) {
      const float t_in = __fadd_rn(t_enter, 1e-5f);
      // per axis: the voxel, its step (+1 or -1) and that step in the flat
      // index (strides R^2, R, 1), the crossing's increment and the next
      // crossing
      int voxel[3], step[3], moved[3];
      float t_delta[3], t_max[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float d = d3[a];
        const float entry = fma_via_f64(guarded(d), t_in, org[a]);
        const float cell = fminf(
            fmaxf(floorf(__fdiv_rn(__fsub_rn(entry, lo[a]), vsize[a])), 0.f),
            static_cast<float>(r - 1));
        voxel[a] = static_cast<int>(cell);
        const int ahead = d >= 0.f;
        step[a] = ahead ? 1 : -1;
        moved[a] = step[a] * (a == 0 ? r * r : (a == 1 ? r : 1));
        t_delta[a] = fabsf(__fmul_rn(vsize[a], inv[a]));
        const float bound = fma_via_f64(static_cast<float>(voxel[a] + ahead),
                                        vsize[a], lo[a]);
        t_max[a] = __fmul_rn(__fsub_rn(bound, org[a]), inv[a]);
      }
      const unsigned char* grid =
          occ + static_cast<long long>(env) * r * r * r;
      int flat = (voxel[0] * r + voxel[1]) * r + voxel[2];
      float t = t_enter;
      for (int i = 0; i < max_steps; ++i) {
        ++count;
        if (__ldg(grid + flat)) {
          found = true;
          t_hit = t;
          break;
        }
        const bool on_x = t_max[0] <= t_max[1] && t_max[0] <= t_max[2];
        const bool on_y = !on_x && t_max[1] <= t_max[2];
        const bool on_z = !on_x && !on_y;
        t = on_x ? t_max[0] : (on_y ? t_max[1] : t_max[2]);
        t_max[0] = __fadd_rn(t_max[0], on_x ? t_delta[0] : 0.f);
        t_max[1] = __fadd_rn(t_max[1], on_y ? t_delta[1] : 0.f);
        t_max[2] = __fadd_rn(t_max[2], on_z ? t_delta[2] : 0.f);
        voxel[0] += on_x ? step[0] : 0;
        voxel[1] += on_y ? step[1] : 0;
        voxel[2] += on_z ? step[2] : 0;
        flat += on_x ? moved[0] : (on_y ? moved[1] : moved[2]);
        if (static_cast<unsigned>(voxel[0]) >= static_cast<unsigned>(r) ||
            static_cast<unsigned>(voxel[1]) >= static_cast<unsigned>(r) ||
            static_cast<unsigned>(voxel[2]) >= static_cast<unsigned>(r))
          break;
      }
    }
    depth[ray] = found ? fminf(t_hit, depth_max) : depth_max;
    hit[ray] = found;
  }
  if (reads != nullptr) {
    // every lane takes part, those past the last ray with a count of 0
    const unsigned warp = __reduce_add_sync(0xffffffffu, count);
    if ((threadIdx.x & 31) == 0 && warp != 0)
      atomicAdd(reads, static_cast<unsigned long long>(warp));
  }
}

}  // namespace

// occ [b, r^3] uint8 (nonzero solid), box_lo, box_hi, origin [b, 3] and
// dirs [b, p, 3] float32, depth [b, p] float32 and hit [b, p] uint8 (both
// written in full), all contiguous on the current device; reads a zeroed
// uint64 on it, or null.  Launches the kernel once on `stream` and returns
// cudaGetLastError() (0 on success).  It does not synchronise.
extern "C" int raymarch(const unsigned char* occ, const float* box_lo,
                        const float* box_hi, const float* origin,
                        const float* dirs, float* depth, unsigned char* hit,
                        unsigned long long* reads, int b, int p, int r,
                        int max_steps, float depth_max, void* stream) {
  if (b <= 0 || p <= 0 || r <= 0 || max_steps < 0 ||
      static_cast<long long>(r) * r * r > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rays = static_cast<long long>(b) * p;
  const long long blocks = (rays + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  raymarch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      occ, box_lo, box_hi, origin, dirs, depth, hit, reads, rays, p, r,
      max_steps, depth_max);
  return static_cast<int>(cudaGetLastError());
}
