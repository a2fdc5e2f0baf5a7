// Bresenham free-space carve (the reference's 3-D Bresenham rays,
// gennbv/utils.py:24-227), batched over envs, for Hopper (sm_90a): one
// launch of one kernel, one thread a (env, target) ray.
//
// For every env n and target t with valid[n, t] set, the integer
// Bresenham ray from the camera voxel src[n] to targets[n, t] marks each
// in-grid voxel it visits in the env's mask out[n] of G^3 floats (the
// caller zeroes it):
//   out[n, (x * G + y) * G + z] = 1.0f.
// This is the plain loop of ops/carve.py (bresenham_traversed_ref) and of
// the JAX package (gennbv_tpu/ops/carve.py::bresenham_traversed, an XLA
// loop: there is no TPU kernel of it).  That loop steps every target slot
// of every env together, valid or not, for 3G iterations of ~30 launches
// each; here each valid thread holds its ray's state in registers and
// runs its own points, and an invalid one returns at once.
//
// The integer arithmetic is the loop's, step for step:
//   - the dominant axis c is x if dx >= dy and dx >= dz, else y if
//     dy >= dz, else z; the other two are (o1, o2) = (y, z), (x, z) or
//     (x, y), in that order;
//   - the error terms start at p1 = 2 d1 - dc and p2 = 2 d2 - dc;
//   - at point i = 0 ... min(dc, max_pts - 1) (dc is the largest distance,
//     so the cap is the reference's max_pts_per_ray) the thread marks its
//     voxel if it lies in the grid, then advances: a step on c, a step on
//     o1 where p1 >= 0 (p1 -= 2 dc), one on o2 where p2 >= 0 (p2 -= 2 dc),
//     then p1 += 2 d1 and p2 += 2 d2.
// Points outside the grid are stepped through and mark nothing.  Every
// store writes the same 1.0f, so stores of several threads to one voxel
// give the same bits in any order: no atomics.
//
// What bounds it on an H100: nothing of the card's.  At dda400.eval's step
// (50 envs x 8,000 target slots of a 20^3 grid) the valid rays are the hit
// voxels, each at most 3G = 60 points of ~12 integer operations, and the
// mask is 1.6 MB; the call is the zero fill and this launch, and its time
// is the launches'.  Consecutive threads take consecutive targets of one
// env, which share the source and start on the same voxels.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;   // a CTA's threads
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int pick(int axis, int a0, int a1, int a2) {
  return axis == 0 ? a0 : (axis == 1 ? a1 : a2);
}

__device__ __forceinline__ int sign_of(int v) { return (v > 0) - (v < 0); }

__global__ void __launch_bounds__(kThreads)
    bresenham_kernel(const int* __restrict__ src,
                     const int* __restrict__ targets, long long target_stride,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ out, int n, int r, int g,
                     int max_pts) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= r) return;
  const long long cells = static_cast<long long>(g) * g * g;
  for (int env = blockIdx.y; env < n; env += gridDim.y) {
    if (!valid[static_cast<long long>(env) * r + t]) continue;
    const int* s = src + 3 * static_cast<long long>(env);
    const int* q = targets + env * target_stride + 3 * static_cast<long long>(t);
    const int x = s[0], y = s[1], z = s[2];
    const int ex = q[0] - x, ey = q[1] - y, ez = q[2] - z;
    const int dx = abs(ex), dy = abs(ey), dz = abs(ez);
    // each axis as (coordinate, distance, step, stride in the flat index)
    // in the loop's order: the dominant axis c, then o1, then o2; picked
    // by selects, so that nothing is indexed at run time
    const int c = (dx >= dy && dx >= dz) ? 0 : (dy >= dz ? 1 : 2);
    const int o1 = c == 0 ? 1 : 0;
    const int o2 = c == 2 ? 1 : 2;
    int pc = pick(c, x, y, z), p1pos = pick(o1, x, y, z),
        p2pos = pick(o2, x, y, z);
    const int dc = pick(c, dx, dy, dz), d1 = pick(o1, dx, dy, dz),
              d2 = pick(o2, dx, dy, dz);
    const int sc = pick(c, sign_of(ex), sign_of(ey), sign_of(ez)),
              s1 = pick(o1, sign_of(ex), sign_of(ey), sign_of(ez)),
              s2 = pick(o2, sign_of(ex), sign_of(ey), sign_of(ez));
    const int wc = pick(c, g * g, g, 1), w1 = pick(o1, g * g, g, 1),
              w2 = pick(o2, g * g, g, 1);
    int p1 = 2 * d1 - dc;
    int p2 = 2 * d2 - dc;
    const int last = dc < max_pts - 1 ? dc : max_pts - 1;
    float* grid = out + env * cells;
    for (int i = 0; i <= last; ++i) {
      if (static_cast<unsigned>(pc) < static_cast<unsigned>(g) &&
          static_cast<unsigned>(p1pos) < static_cast<unsigned>(g) &&
          static_cast<unsigned>(p2pos) < static_cast<unsigned>(g))
        grid[pc * wc + p1pos * w1 + p2pos * w2] = 1.0f;
      pc += sc;
      if (p1 >= 0) {
        p1pos += s1;
        p1 -= 2 * dc;
      }
      if (p2 >= 0) {
        p2pos += s2;
        p2 -= 2 * dc;
      }
      p1 += 2 * d1;
      p2 += 2 * d2;
    }
  }
}

}  // namespace

// src [n, 3] int32 camera voxels; targets int32 [r, 3] (target_stride 0:
// every env's) or [n, r, 3] (target_stride 3r), targets[t] in the grid;
// valid [n, r] uint8 (nonzero: the ray is carved); out [n, g^3] float32,
// zeroed; all contiguous on the current device.  Launches the kernel once
// on `stream` and returns cudaGetLastError() (0 on success).  It does not
// synchronise.
extern "C" int bresenham(const int* src, const int* targets,
                         long long target_stride, const unsigned char* valid,
                         float* out, int n, int r, int g, int max_pts,
                         void* stream) {
  if (n <= 0 || r <= 0 || g <= 0 || max_pts < 0 || target_stride < 0 ||
      static_cast<long long>(g) * g * g > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((r + kThreads - 1) / kThreads,
                    n < kMaxGridY ? n : kMaxGridY);
  bresenham_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, targets, target_stride, valid, out, n, r, g, max_pts);
  return static_cast<int>(cudaGetLastError());
}
