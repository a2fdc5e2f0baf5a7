// Deterministic weight and bias gradients of a valid 3-D convolution with a
// 3x3x3 kernel and stride 2, in float32, for Hopper (sm_90a): two launches,
// no atomics, no tensor cores.
//
//   dW[co, ci, kd, kh, kw] = sum_{n, od, oh, ow} dY[n, co, od, oh, ow]
//                            * X[n, ci, 2 od + kd, 2 oh + kh, 2 ow + kw]
//   db[co]                 = sum_{n, od, oh, ow} dY[n, co, od, oh, ow]
//
// It replaces no TPU kernel: the JAX encoder's convolutions are XLA's.  It
// serves the backward pass of the HybridEncoder's two Conv3d layers in the
// PPO update (ops/conv3d_wgrad.py), where cuDNN's deterministic weight
// gradient for these shapes (its grouped direct kernel, the one cuDNN picks
// under cudnn.deterministic) took 80-300 times the shapes' least time.
//
// What bounds it on an H100: memory and latency, not arithmetic.  At the
// update's minibatch (N = 128) the first layer (1 -> 16 channels, 20^3 ->
// 9^3) reads 4.1 MB of X and 6.0 MB of dY for 80.6 MFLOP, ~3.0 us at
// 3.35 TB/s; the second (16 -> 16, 9^3 -> 4^3) reads 6.0 + 0.5 MB for
// 113 MFLOP, ~2.0 us.  As a product, dW is [C_out x (C_in * 27 + 1)] (the
// bias a column of ones) summed over N * D_out * H_out * W_out positions: a
// small output and a long reduction.  So:
//   - the positions are cut into fixed contiguous chunks, about two an SM
//     (ops/conv3d_wgrad.py::geometry), one CTA a chunk: a split-K whose
//     order is fixed by the chunk and not by which CTA runs first;
//   - a CTA stages a tile of its chunk's positions in shared memory: dY as
//     [C_out][tile] (threads along positions: coalesced reads, and stores
//     free of bank conflicts) and the input patches as [tile][C_in * 27 +
//     1] (im2col on the fly; offsets from tables of the tile's positions
//     and of the patch's taps); the copy is bound by the latency of its
//     loads, so each thread issues kBatch of them before it stores any,
//     stepping its element's indices without a division; then every
//     thread accumulates fixed register blocks of 4 channels x 4 patch
//     columns over the tile, four scalar loads and one float4 load from
//     shared memory for 16 FMAs;
//   - where the output has fewer blocks than the CTA has threads (the
//     first layer: 28 blocks), the threads split the tile's positions
//     among themselves as well (thread part q takes positions q, q +
//     parts, ...), and the CTA sums the parts in order through shared
//     memory; where it has more than two blocks a thread, the blocks are
//     cut into slabs, a CTA each (more channels than the encoder's 16);
//   - each CTA writes its chunk's partials to a workspace [chunks, C_out,
//     C_in * 27 + 1], and a second launch sums them per output in a fixed
//     order: kReduceLanes lanes take every kReduceLanes-th chunk in index
//     order, then the lanes' sums are added in lane order.
// Every sum has one fixed order, so the result is the same bit for bit from
// run to run (trainings from one seed stay bit-equal); it differs from
// cuDNN's and from the CPU's only by the order of float32 additions.
#include <cuda_runtime.h>
#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 27;         // 3 x 3 x 3
constexpr int kStride = 2;
constexpr int kRC = 4;            // output channels of a register block
constexpr int kRK = 4;            // patch columns of a register block
constexpr int kMaxBlocks = 2;     // register blocks a thread holds
constexpr int kBatch = 8;         // loads a thread issues before storing them
constexpr int kReduceLanes = 32;  // lanes summing one output's chunks
constexpr int kMaxDevices = 64;

struct Shape {
  int cin, d, h, w;               // X [n, cin, d, h, w], inner dims contiguous
  int x_batch;                    // elements from one sample of X to the next
  int cout, oh, ow, ovol;         // dY [n, cout, od, oh, ow], contiguous
  int k1;                         // patch columns: cin * 27
  int k;                          // with the bias column: k1 + 1
  int kp, cp;                     // k and cout rounded up to 4
  int positions;                  // n * ovol
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Floats of the part of shared memory that holds a tile, or after the last
// tile the parts' sums: the larger of the two.
__device__ __forceinline__ int union_floats(const Shape& s, int tile) {
  return max(tile * (s.cp + s.kp), kThreads * kRC * kRK);
}

__device__ __forceinline__ void fma_block(float (&acc)[kRC][kRK],
                                          const float (&a)[kRC], float4 b) {
  const float bv[kRK] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < kRC; ++i)
#pragma unroll
    for (int j = 0; j < kRK; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
}

// One CTA a (chunk, slab): the partial sums of the slab's register blocks
// over the chunk's positions [blockIdx.x * chunk, + chunk), written to
// ws[blockIdx.x, co, k] for co < cout, k < k.
__global__ void __launch_bounds__(kThreads, 2)
conv3d_wgrad_partial_kernel(const float* __restrict__ x,
                            const float* __restrict__ dy,
                            float* __restrict__ ws, Shape s, int chunk,
                            int tile, int slab_blocks) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                       // [cp][tc] of a tile of tc
  float* xs = dys + tile * s.cp;           // [tile][kp]
  float* red = smem;                       // [parts][slots][16], after the tiles
  int* koff = reinterpret_cast<int*>(smem + union_floats(s, tile));  // [k1]
  int* xbase = koff + s.k1;                // [tile]
  int* dyoff = xbase + tile;               // [tile]

  const int tid = threadIdx.x;
  const int kblocks = s.kp / kRK;
  const int blocks = (s.cp / kRC) * kblocks;
  const int slab_lo = blockIdx.y * slab_blocks;
  const int slab_n = min(slab_blocks, blocks - slab_lo);
  // thread (part, slot) holds blocks slab_lo + slot + j * slots, j < nb
  const int slots = min(slab_n, kThreads);
  const int parts = kThreads / slots;
  const int slot = tid % slots, part = tid / slots;
  const bool computes = part < parts;
  const int nb = computes ? (slab_n - slot + slots - 1) / slots : 0;
  int cb[kMaxBlocks], kb[kMaxBlocks];
#pragma unroll
  for (int j = 0; j < kMaxBlocks; ++j) {
    const int b = slab_lo + slot + j * slots;
    cb[j] = b / kblocks;
    kb[j] = b % kblocks;
  }
  float acc[kMaxBlocks][kRC][kRK];
#pragma unroll
  for (int j = 0; j < kMaxBlocks; ++j)
#pragma unroll
    for (int i = 0; i < kRC; ++i)
#pragma unroll
      for (int q = 0; q < kRK; ++q) acc[j][i][q] = 0.f;

  const int hw = s.h * s.w;
  const int dhw = s.d * hw;
  for (int k = tid; k < s.k1; k += kThreads) {
    const int ci = k / kTaps, tap = k % kTaps;
    koff[k] = ci * dhw + tap / 9 * hw + tap / 3 % 3 * s.w + tap % 3;
  }

  const int p_begin = blockIdx.x * chunk;
  const int p_end = min(p_begin + chunk, s.positions);
  for (int p0 = p_begin; p0 < p_end; p0 += tile) {
    const int tc = min(tile, p_end - p0);
    __syncthreads();                       // the last tile's readers are done
    for (int t = tid; t < tc; t += kThreads) {
      const int p = p0 + t;
      const int n = p / s.ovol, v = p % s.ovol;
      const int ow = v % s.ow, oh = v / s.ow % s.oh, od = v / (s.ow * s.oh);
      xbase[t] = n * s.x_batch + kStride * (od * hw + oh * s.w + ow);
      dyoff[t] = n * s.cout * s.ovol + v;
    }
    __syncthreads();
    // dY's element e = co * tc + t, threads along positions; the patches'
    // e = t * kp + k, threads along columns.  A thread walks its elements
    // e = tid + i * kThreads, stepping (co, t) or (t, k) without a
    // division, and issues kBatch loads before it stores them.
    {
      const int total = s.cp * tc;
      const int dco = kThreads / tc, dt = kThreads % tc;
      int co = tid / tc, t = tid % tc;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          v[i] = 0.f;
          if (e0 + i * kThreads < total && co < s.cout)
            v[i] = __ldg(dy + dyoff[t] + co * s.ovol);
          co += dco;
          t += dt;
          if (t >= tc) {
            t -= tc;
            ++co;
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (e0 + i * kThreads < total) dys[e0 + i * kThreads] = v[i];
      }
    }
    {
      const int total = tc * s.kp;
      const int dt = kThreads / s.kp, dk = kThreads % s.kp;
      int t = tid / s.kp, k = tid % s.kp;
      for (int e0 = tid; e0 < total; e0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          v[i] = 0.f;
          if (e0 + i * kThreads < total) {
            if (k < s.k1)
              v[i] = __ldg(x + xbase[t] + koff[k]);
            else if (k == s.k1)
              v[i] = 1.f;
          }
          t += dt;
          k += dk;
          if (k >= s.kp) {
            k -= s.kp;
            ++t;
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (e0 + i * kThreads < total) xs[e0 + i * kThreads] = v[i];
      }
    }
    __syncthreads();
    if (computes) {
      for (int t = part; t < tc; t += parts) {
#pragma unroll
        for (int j = 0; j < kMaxBlocks; ++j) {
          if (j < nb) {
            float a[kRC];
#pragma unroll
            for (int i = 0; i < kRC; ++i)
              a[i] = dys[(cb[j] * kRC + i) * tc + t];
            const float4 b = *reinterpret_cast<const float4*>(
                xs + t * s.kp + kb[j] * kRK);
            fma_block(acc[j], a, b);
          }
        }
      }
    }
  }

  float* out = ws + static_cast<size_t>(blockIdx.x) * s.cout * s.k;
  if (parts == 1) {
#pragma unroll
    for (int j = 0; j < kMaxBlocks; ++j) {
      if (j >= nb) continue;
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const int co = cb[j] * kRC + i;
#pragma unroll
        for (int q = 0; q < kRK; ++q) {
          const int k = kb[j] * kRK + q;
          if (co < s.cout && k < s.k) out[co * s.k + k] = acc[j][i][q];
        }
      }
    }
    return;
  }
  // parts > 1: slots < kThreads, so each computing thread holds one block
  __syncthreads();                         // red aliases the last tile
  if (computes) {
#pragma unroll
    for (int i = 0; i < kRC; ++i)
#pragma unroll
      for (int q = 0; q < kRK; ++q)
        red[(part * slots + slot) * kRC * kRK + i * kRK + q] = acc[0][i][q];
  }
  __syncthreads();
  for (int e = tid; e < slots * kRC * kRK; e += kThreads) {
    const int sl = e / (kRC * kRK), iq = e % (kRC * kRK);
    float sum = red[e];
    for (int pt = 1; pt < parts; ++pt) sum += red[pt * slots * kRC * kRK + e];
    const int b = slab_lo + sl;
    const int co = b / kblocks * kRC + iq / kRK;
    const int k = b % kblocks * kRK + iq % kRK;
    if (co < s.cout && k < s.k) out[co * s.k + k] = sum;
  }
}

// One thread column an output o of [cout, k]: lane r sums chunks r, r +
// kReduceLanes, ... in index order, then lane 0 adds the lanes' sums in
// lane order and writes dW or, for the bias column, db.
__global__ void __launch_bounds__(32 * kReduceLanes)
conv3d_wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                           float* __restrict__ db, int outputs, int k1,
                           int chunks) {
  __shared__ float lanes[kReduceLanes][32];
  const int o = blockIdx.x * 32 + threadIdx.x;
  const int r = threadIdx.y;
  float sum = 0.f;
  if (o < outputs) {
#pragma unroll 8
    for (int c = r; c < chunks; c += kReduceLanes)
      sum += ws[static_cast<size_t>(c) * outputs + o];
  }
  lanes[r][threadIdx.x] = sum;
  __syncthreads();
  if (r != 0 || o >= outputs) return;
  float total = lanes[0][threadIdx.x];
#pragma unroll
  for (int q = 1; q < kReduceLanes; ++q) total += lanes[q][threadIdx.x];
  const int co = o / (k1 + 1), k = o % (k1 + 1);
  if (k < k1)
    dw[co * k1 + k] = total;
  else
    db[co] = total;
}

// Lets the partial kernel take the device's whole opt-in shared memory, once
// a device (an attribute of the function, not a stream operation).
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
  err = cudaFuncSetAttribute(conv3d_wgrad_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// x [n, cin, d, h, w] float32 whose inner four dims are contiguous, samples
// x_batch elements apart; dy [n, cout, od, oh, ow] float32 contiguous, with
// od = (d - 3) / 2 + 1 (and so for h, w); ws a workspace of chunks * cout *
// (cin * 27 + 1) floats; dw [cout, cin, 3, 3, 3] and db [cout] float32
// contiguous, written in full.  The n * od * oh * ow positions are cut into
// `chunks` chunks of `chunk` (the last may be shorter), each staged `tile`
// positions at a time; the register blocks into slabs of `slab_blocks`.
// Launches the two kernels on `stream` and returns cudaGetLastError() (0 on
// success); a geometry that does not cover the positions, or that needs
// more shared memory or registers than a CTA has, is an error.  It does not
// synchronise.
extern "C" int conv3d_wgrad(const float* x, const float* dy, float* ws,
                            float* dw, float* db, int n, int cin, int d, int h,
                            int w, int x_batch, int cout, int chunk,
                            int chunks, int tile, int slab_blocks,
                            void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || d < 3 || h < 3 || w < 3 ||
      chunk <= 0 || chunks <= 0 || tile <= 0 || tile > chunk ||
      slab_blocks <= 0 || slab_blocks > kThreads * kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.cin = cin;
  s.d = d;
  s.h = h;
  s.w = w;
  s.cout = cout;
  const long long od = (d - 3) / kStride + 1;
  s.oh = (h - 3) / kStride + 1;
  s.ow = (w - 3) / kStride + 1;
  const long long dhw = static_cast<long long>(d) * h * w;
  const long long ovol = od * s.oh * s.ow;
  const long long positions = n * ovol;
  const long long k1 = 27LL * cin;
  if (k1 + 4 > INT_MAX / 4 || cout > INT_MAX / 4 || ovol > INT_MAX ||
      positions > INT_MAX || (n > 1 && x_batch < cin * dhw) ||
      static_cast<long long>(n - 1) * x_batch + cin * dhw > INT_MAX ||
      positions * cout > INT_MAX ||
      static_cast<long long>(chunk) * (chunks - 1) >= positions ||
      static_cast<long long>(chunk) * chunks < positions ||
      static_cast<long long>(chunk) * chunks > INT_MAX ||
      static_cast<long long>(chunks) * cout * (k1 + 1) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  s.x_batch = x_batch;
  s.ovol = static_cast<int>(ovol);
  s.positions = static_cast<int>(positions);
  s.k1 = static_cast<int>(k1);
  s.k = s.k1 + 1;
  s.kp = round4(s.k);
  s.cp = round4(cout);
  const long long blocks = static_cast<long long>(s.cp / kRC) * (s.kp / kRK);
  const long long slabs = (blocks + slab_blocks - 1) / slab_blocks;
  const long long smem_floats = static_cast<long long>(tile) * (s.cp + s.kp) >
                                        kThreads * kRC * kRK
                                    ? static_cast<long long>(tile) * (s.cp + s.kp)
                                    : kThreads * kRC * kRK;
  const long long smem = 4 * (smem_floats + s.k1 + 2LL * tile);
  if (slabs > 65535 || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_full_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv3d_wgrad_partial_kernel<<<dim3(chunks, static_cast<unsigned>(slabs)),
                                kThreads, static_cast<size_t>(smem), st>>>(
      x, dy, ws, s, chunk, tile, slab_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = cout * s.k;
  conv3d_wgrad_reduce_kernel<<<(outputs + 31) / 32, dim3(32, kReduceLanes), 0,
                               st>>>(ws, dw, db, outputs, s.k1, chunks);
  return static_cast<int>(cudaGetLastError());
}
