// Batched voxel "any-hit" scatter, for Hopper (sm_90a).
//
//   grid[n, (x * G + y) * G + z] = 1.0f  for every valid point (x, y, z)
//
// Replaces the TPU kernel gennbv_tpu/ops/pallas_scatter.py::_kernel (called
// through pallas_scatter.scatter_cells_any), which counts hits as one-hot
// products [G, 512] x [512, G^2] per chunk of points in VMEM, so that the
// TPU's matrix unit does the scatter, and thresholds the counts at 0.5.  A
// GPU stores directly: one thread per point, and a valid point stores 1.0f
// to its cell of a grid that the caller zeroed.  Every store writes the
// same value, so concurrent stores to one cell need no atomics and the
// result does not depend on their order.
//
// What bounds it on an H100: memory, and at these sizes launch cost.  Per
// point it reads 12 bytes of indices and 1 byte of validity, coalesced;
// the stores are random 4-byte writes into 32 KB per env (G = 20), which
// stay in L2.  No shared memory is needed.
//
// Indices must be in [0, G) (the callers clamp them); they are clamped here
// as well so that a bad index can never write outside its env's grid.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void scatter_cells_any_kernel(const int* __restrict__ idx,
                                         const uint8_t* __restrict__ valid,
                                         float* __restrict__ grid,
                                         int p, int g) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p) return;
  const long long n = blockIdx.y;
  const long long i = n * p + k;
  if (!__ldg(valid + i)) return;
  const int x = min(max(__ldg(idx + 3 * i), 0), g - 1);
  const int y = min(max(__ldg(idx + 3 * i + 1), 0), g - 1);
  const int z = min(max(__ldg(idx + 3 * i + 2), 0), g - 1);
  grid[n * g * g * g + (x * g + y) * g + z] = 1.0f;
}

}  // namespace

// idx [n, p, 3] int32, valid [n, p] bool (one byte each), grid [n, g^3]
// float32 zeroed by the caller, all contiguous on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int scatter_cells_any(const int* idx, const uint8_t* valid,
                                 float* grid, int n, int p, int g,
                                 void* stream) {
  if (n == 0 || p == 0) return 0;
  constexpr int kThreads = 256;
  const dim3 blocks((p + kThreads - 1) / kThreads, n);
  scatter_cells_any_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      idx, valid, grid, p, g);
  return static_cast<int>(cudaGetLastError());
}
