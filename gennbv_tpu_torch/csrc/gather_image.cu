// Batched per-point image gather with bf16 rounding, for Hopper (sm_90a).
//
//   out[n, q] = float(bf16_rne(img[n, vi[n, q], ui[n, q]]))
//
// Replaces the TPU kernel gennbv_tpu/ops/pallas_gather.py::_kernel (called
// through pallas_gather.gather_image), which reads the same values as one
// one-hot dot per 512-point chunk so that the TPU's matrix unit does the
// lookup.  A GPU reads the value directly, so this kernel is one thread per
// output: two coalesced index loads, one random 4-byte image load, one
// coalesced store.
//
// What bounds it on an H100: memory latency and launch cost, not
// arithmetic.  On the rollout path (256 envs, 128x128 images, 11264 or 8000
// points per env) the 16 MB of float32 images sit in the 50 MB L2, so the
// random loads hit L2.  At 128x128 no shared memory is needed, and wgmma
// and TMA have nothing to offer a gather.  Reads go through the read-only
// path (__ldg).
//
// Indices must be in range (the callers clip them); they are clamped here
// as well so that a bad index can never read outside the image.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__global__ void gather_image_kernel(const float* __restrict__ img,
                                    const int* __restrict__ vi,
                                    const int* __restrict__ ui,
                                    float* __restrict__ out,
                                    int q, int h, int w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= q) return;
  const long long n = blockIdx.y;
  const long long idx = n * q + k;
  const int v = min(max(__ldg(vi + idx), 0), h - 1);
  const int u = min(max(__ldg(ui + idx), 0), w - 1);
  const float x = __ldg(img + (n * h + v) * w + u);
  out[idx] = __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace

// img [n, h, w] float32, vi/ui [n, q] int32, out [n, q] float32, all
// contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int gather_image(const float* img, const int* vi, const int* ui,
                            float* out, int n, int q, int h, int w,
                            void* stream) {
  if (n == 0 || q == 0) return 0;
  constexpr int kThreads = 256;
  const dim3 grid((q + kThreads - 1) / kThreads, n);
  gather_image_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      img, vi, ui, out, q, h, w);
  return static_cast<int>(cudaGetLastError());
}
