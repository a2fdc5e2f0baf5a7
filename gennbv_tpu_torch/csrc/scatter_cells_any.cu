// Batched voxel "any-hit" scatter, for Hopper (sm_90a): one launch of one
// kernel, one CTA per env, the env's grid of hit flags in shared memory.
//
//   grid[n, (x * G + y) * G + z] = 1.0f  for every valid point (x, y, z),
//   0.0f in every other cell
//
// Replaces the TPU kernel gennbv_tpu/ops/pallas_scatter.py::_kernel (called
// through pallas_scatter.scatter_cells_any), which counts hits as one-hot
// products [G, 512] x [512, G^2] per chunk of points in VMEM, so that the
// TPU's matrix unit does the scatter, and thresholds the counts at 0.5.  A
// GPU stores directly, and the grid is small: G^3 byte flags, 8 KB at
// G = 20, so one CTA holds an env's whole grid.
//
// What bounds it on an H100: memory, and at these sizes launch cost.  The
// least traffic is every point's validity (1 B), the valid points' indices
// (12 B) and the grid written once (4 B a cell).  The grid is written once
// here, by the kernel itself: nothing zeroes it beforehand, so a call is one
// device launch.
//
// Layout.  One CTA per env, its G^3 flags (rounded up to a multiple of 16
// bytes) in dynamic shared memory:
//   1. the CTA zeroes its flags (16-byte stores) while its threads read
//      their first batch of points; block barrier;
//   2. each valid point stores 1 into its cell's flag.  Every store writes
//      the same value, so concurrent stores to one cell need no atomics and
//      the result does not depend on their order.  A thread reads kBatch
//      points' validity bytes at once, then the valid ones' indices at once,
//      so that it waits for memory twice a batch; block barrier;
//   3. the CTA writes the flags out as float 0.0/1.0, four cells a thread
//      with one 16-byte store where the address allows it.
//
// Indices must be in [0, G) (the callers clamp them); they are clamped here
// as well so that a bad index can never write outside its env's grid.
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kBatch = 4;      // points a thread reads at once
constexpr int kMaxDevices = 64;

// A thread's batch of points base + j * kThreads (j < kBatch) below p: the
// cell of each valid one, -1 for the others.  The validity bytes are read
// at once, then the valid points' indices at once.
struct Batch {
  int cell[kBatch];
};

__device__ __forceinline__ Batch load_batch(const int* __restrict__ idx,
                                            const uint8_t* __restrict__ valid,
                                            long long pts, int base, int p,
                                            int g) {
  bool ok[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = base + j * kThreads;
    ok[j] = k < p && __ldg(valid + pts + k);
  }
  Batch b;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    b.cell[j] = -1;
    if (ok[j]) {
      const long long i = pts + base + j * kThreads;
      const int x = min(max(__ldg(idx + 3 * i), 0), g - 1);
      const int y = min(max(__ldg(idx + 3 * i + 1), 0), g - 1);
      const int z = min(max(__ldg(idx + 3 * i + 2), 0), g - 1);
      b.cell[j] = (x * g + y) * g + z;
    }
  }
  return b;
}

__device__ __forceinline__ void mark(uint8_t* flags, const Batch& b) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (b.cell[j] >= 0) flags[b.cell[j]] = 1;
}

__global__ void __launch_bounds__(kThreads, 2)
scatter_cells_any_kernel(const int* __restrict__ idx,
                         const uint8_t* __restrict__ valid,
                         float* __restrict__ grid, int p, int g,
                         int flag_bytes) {
  const long long n = blockIdx.x;
  extern __shared__ __align__(16) uint8_t flags[];       // [flag_bytes]
  const long long pts = n * p;
  constexpr int kStep = kBatch * kThreads;   // from one batch to the next

  // 1. the env's cells start empty, while the first batch of points is read
  const Batch held = load_batch(idx, valid, pts, threadIdx.x, p, g);
  int4* flags16 = reinterpret_cast<int4*>(flags);
  for (int i = threadIdx.x; i < flag_bytes / 16; i += kThreads)
    flags16[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 2. every valid point marks its cell
  mark(flags, held);
  for (int base = threadIdx.x + kStep; base < p; base += kStep)
    mark(flags, load_batch(idx, valid, pts, base, p, g));
  __syncthreads();

  // 3. the cells out as float
  const int cells = g * g * g;
  float* out = grid + n * cells;
  for (int c = 4 * threadIdx.x; c < cells; c += 4 * kThreads) {
    const uint8_t* f = flags + c;
    if (c + 4 <= cells && reinterpret_cast<uintptr_t>(out + c) % 16 == 0) {
      *reinterpret_cast<float4*>(out + c) =
          make_float4(f[0], f[1], f[2], f[3]);
    } else {
      for (int e = 0; e < 4 && c + e < cells; ++e) out[c + e] = f[e];
    }
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
  err = cudaFuncGetAttributes(&attr, scatter_cells_any_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scatter_cells_any_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// idx [n, p, 3] int32, valid [n, p] bool (one byte each), grid [n, g^3]
// float32 (written in full: it need not be zeroed), all contiguous on the
// current device; n > 0.  One CTA per env with `flag_bytes` bytes of
// dynamic shared memory (g^3 rounded up to a multiple of 16).  Launches the
// kernel once on `stream` and returns cudaGetLastError() (0 on success); a
// grid too large for the CTA's shared memory is an error.  It does not
// synchronise.
extern "C" int scatter_cells_any(const int* idx, const uint8_t* valid,
                                 float* grid, int n, int p, int g,
                                 int flag_bytes, void* stream) {
  const cudaError_t err = allow_full_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_cells_any_kernel<<<n, kThreads, flag_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      idx, valid, grid, p, g, flag_bytes);
  return static_cast<int>(cudaGetLastError());
}
