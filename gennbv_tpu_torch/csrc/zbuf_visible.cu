// Fused splat z-buffer + per-point visibility, batched over envs, for
// Hopper (sm_90a): one launch of one kernel, one thread-block cluster per
// env, the env's key image held in the cluster's distributed shared memory.
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
// one-hot products on its matrix unit, skips 512-point chunks with no valid
// point, and keeps the env's image in VMEM scratch.  Here the minimum is an
// integer atomicMin on the key, exact for any number of points per pixel;
// outputs stay in point order, so nothing is sorted.
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
// What bounds it on an H100: memory.  The least traffic is the points read
// once (13 B each, 1 B for an invalid one), the z-buffer written once (4 B a
// pixel) and the visibility written once (1 B a point): a few integer and
// float operations per byte.  The key image is the one large intermediate
// (4 B a pixel: 32 MB for 50 envs at 400x400), and this design never lets
// it reach device memory, as the TPU kernel kept it in VMEM.
//
// Layout.  One cluster of C CTAs (C <= 8, ops/fused_splat.py picks it) per
// env; CTA r owns the band of rows [r * band, min((r + 1) * band, H)),
// band = ceil(H / C) >= f when C > 1, so a pixel's window reaches no further
// than the neighbouring bands.  Its dynamic shared memory holds the band's
// int32 keys and a byte image of as many pixels (a key is at most 100),
// rows padded to a multiple of 4 pixels: 5 B a pixel.  The env's points are
// split evenly over the CTAs.  Phases, separated by cluster barriers:
//   1. each CTA reduces min and max of z over its points and fills its
//      band's keys with 100; the C partials are then combined through
//      distributed shared memory, so every CTA holds the same zmin, zrange,
//      and a table of the 101 keys' decoded depths (and their bf16
//      roundings): no pixel or point decodes on its own;
//   2. each valid point's key goes to its pixel by an atomicMin on the
//      owning CTA's band (a shared-memory atomic there; atomics on
//      distributed shared memory are native on sm_90);
//   3. each CTA min-pools its band, separably, on keys packed four to a
//      32-bit word (__vminu4 takes four minima at once): the keys into the
//      byte image; their row mins, from funnel shifts of neighbouring
//      words, into the key words, which nothing reads any more; then, after
//      a barrier, the column mins over the (2f+1) row mins, the
//      neighbouring bands' edge rows read through distributed shared
//      memory.  The pooled keys go to the byte image; after the barrier's
//      arrival their depths go to the z-buffer with 16-byte stores where
//      the row allows, so that the barrier does not wait for those stores.
//      A thread walks the band's words without a division per pixel;
//   4. each point reads the pooled key at its pixel from the owning band
//      and compares its depth with the key's bf16 depth.
// Points are read in batches of kBatch a thread, each batch's validity
// bytes at once and then the valid points' pixel and depth at once, so that
// a thread waits for memory twice a batch.  A thread keeps its first batch
// (band slot, z) in registers from phase 1 to phase 4; later batches are
// read again (from L2).  A last barrier keeps every CTA's shared memory
// alive until the others have read it.  A CTA alone in its cluster takes a
// barrier of its own threads for each cluster barrier, which costs less.
// Nothing for wgmma or TMA to do: the work is scattered, not tiled.
//
// Indices must be in range (the callers clip them); they are clamped here
// as well so that a bad index can never touch memory outside the image.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLevels = 10;
constexpr int kEmptyKey = kLevels * kLevels;
constexpr unsigned kEmptyKey4 = 0x64646464u;   // four empty keys, one a byte
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;      // points a thread reads at once
constexpr int kOwnerShift = 24;
constexpr int kOffsetMask = (1 << kOwnerShift) - 1;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int point_key(float z, float zmin, float zrange) {
  float t = __fmul_rn(__fdiv_rn(__fsub_rn(z, zmin), zrange),
                      static_cast<float>(kLevels));
  t = fminf(fmaxf(t, 0.0f), static_cast<float>(kLevels - 1e-3));
  const float d1 = floorf(t);
  const float d2 = floorf(__fmul_rn(__fsub_rn(t, d1),
                                    static_cast<float>(kLevels)));
  return static_cast<int>(d1) * kLevels + static_cast<int>(d2);
}

__device__ __forceinline__ float decode(int key, float zmin, float zrange,
                                        int footprint, float depth_max) {
  if (key >= kEmptyKey) return depth_max;
  const float m1 = static_cast<float>(key / kLevels);
  const float m2 = static_cast<float>(key % kLevels);
  const float tenth = 0.1f;                // float32 reciprocal of 10
  const float frac10 = __fadd_rn(m1, __fmul_rn(__fadd_rn(m2, 0.5f), tenth));
  const float step = __fmul_rn(zrange, tenth);
  const float zq = static_cast<float>(__dadd_rn(
      __dmul_rn(static_cast<double>(frac10), static_cast<double>(step)),
      static_cast<double>(zmin)));
  // the pool's window starts at depth_max, so a pooled depth never exceeds
  // it; without a footprint there is no pool
  return footprint > 0 ? fminf(zq, depth_max) : zq;
}

// A thread's batch of points base + j * kThreads (j < kBatch) below p1:
// for each valid one its band slot (the rank of the CTA whose band holds
// its row, above the pixel's offset in that band, rows `stride` apart) and
// its depth; slot -1 where there is no valid point.
struct Batch {
  int slot[kBatch];
  float z[kBatch];
};

__device__ __forceinline__ Batch load_batch(
    const int* __restrict__ vi, const int* __restrict__ ui,
    const float* __restrict__ z, const uint8_t* __restrict__ ok,
    long long pts, int base, int p1, int h, int w, int band, int stride) {
  bool valid[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = base + j * kThreads;
    valid[j] = k < p1 && __ldg(ok + pts + k);
  }
  Batch b;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    b.slot[j] = -1;
    b.z[j] = 0.0f;
    if (valid[j]) {
      const long long i = pts + base + j * kThreads;
      const int v = min(max(__ldg(vi + i), 0), h - 1);
      const int u = min(max(__ldg(ui + i), 0), w - 1);
      const int owner = v / band;
      b.slot[j] = owner << kOwnerShift | ((v - owner * band) * stride + u);
      b.z[j] = __ldg(z + i);
    }
  }
  return b;
}

__device__ __forceinline__ void key_min(cg::cluster_group& cluster,
                                        int* keys, unsigned rank, int slot,
                                        int key) {
  const unsigned owner = static_cast<unsigned>(slot) >> kOwnerShift;
  const int off = slot & kOffsetMask;
  if (owner == rank)
    atomicMin(keys + off, key);
  else
    atomicMin(cluster.map_shared_rank(keys, owner) + off, key);
}

__device__ __forceinline__ int pooled_key(cg::cluster_group& cluster,
                                          uint8_t* pooled, unsigned rank,
                                          int slot) {
  const unsigned owner = static_cast<unsigned>(slot) >> kOwnerShift;
  const int off = slot & kOffsetMask;
  return owner == rank ? pooled[off]
                       : cluster.map_shared_rank(pooled, owner)[off];
}

// Four keys of a packed row from column `col` on, one a byte; columns
// outside the row's words read as empty.
__device__ __forceinline__ unsigned bytes_at(const unsigned* row, int qpr,
                                             int col) {
  const int word = col >> 2;                 // rounds down, also below 0
  const unsigned lo = word >= 0 && word < qpr ? row[word] : kEmptyKey4;
  const unsigned hi = word + 1 >= 0 && word + 1 < qpr ? row[word + 1]
                                                      : kEmptyKey4;
  return __funnelshift_r(lo, hi, 8 * (col & 3));
}

// The quads (four pixels, one word) of a band a thread visits: i, i +
// kThreads, ...; lr and c are quad i's row and word in the row, stepped
// without a division.
struct QuadWalk {
  int i, lr, c, qpr, dlr, dc;
  __device__ explicit QuadWalk(int qpr_)
      : i(threadIdx.x), lr(threadIdx.x / qpr_), c(threadIdx.x % qpr_),
        qpr(qpr_), dlr(kThreads / qpr_), dc(kThreads % qpr_) {}
  __device__ void next() {
    i += kThreads;
    lr += dlr;
    c += dc;
    if (c >= qpr) {
      c -= qpr;
      ++lr;
    }
  }
};

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Barriers of the CTA's cluster, split into arrive and wait: what a thread
// wrote to shared memory before it arrives is visible to the whole cluster
// after the wait.  Between the two a CTA may store to device memory, which
// the barrier then does not wait for.  A CTA alone in its cluster needs only
// a barrier of its own threads.
__device__ __forceinline__ void arrive(unsigned ctas) {
  if (ctas == 1)
    __syncthreads();
  else
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void wait(unsigned ctas) {
  if (ctas > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier(unsigned ctas) {
  arrive(ctas);
  wait(ctas);
}

__global__ void __launch_bounds__(kThreads, 2)
zbuf_visible_cluster_kernel(const int* __restrict__ vi,
                            const int* __restrict__ ui,
                            const float* __restrict__ z,
                            const uint8_t* __restrict__ ok,
                            const float* __restrict__ voxel_eps,
                            float* __restrict__ zbuf,
                            uint8_t* __restrict__ visible,
                            int q, int h, int w, int band, int footprint,
                            float depth_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned ctas = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long n = blockIdx.x / ctas;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int stride = (w + 3) & ~3;           // pixels a band row holds

  extern __shared__ __align__(16) unsigned char smem[];
  int* keys = reinterpret_cast<int*>(smem);                // [band, stride]
  uint8_t* packed = smem + sizeof(int) * band * stride;   // [band, stride]
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  __shared__ float s_part[2];     // this CTA's (min, max), read by the cluster
  __shared__ float s_scale[2];    // the env's (zmin, zrange)
  __shared__ float s_depth[kEmptyKey + 1];   // each key's decoded depth
  __shared__ float s_depth16[kEmptyKey + 1];   // ... rounded to bf16

  const int r0 = static_cast<int>(rank) * band;
  const int rows = max(0, min(band, h - r0));
  const int chunk = (q + ctas - 1) / ctas;
  const int p0 = min(q, static_cast<int>(rank) * chunk);
  const int p1 = min(q, p0 + chunk);
  const long long pts = n * q;
  const int first = p0 + threadIdx.x;        // this thread's first point
  constexpr int kStep = kBatch * kThreads;   // from one batch to the next

  // 1. z range of this CTA's points; the band's keys start empty
  const Batch held =
      load_batch(vi, ui, z, ok, pts, first, p1, h, w, band, stride);
  float lo = __int_as_float(0x7f800000);     // +inf
  float hi = __int_as_float(0xff800000);     // -inf
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (held.slot[j] >= 0) {
      lo = fminf(lo, held.z[j]);
      hi = fmaxf(hi, held.z[j]);
    }
  }
  for (int base = first + kStep; base < p1; base += kStep) {
    const Batch b = load_batch(vi, ui, z, ok, pts, base, p1, h, w, band, stride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (b.slot[j] >= 0) {
        lo = fminf(lo, b.z[j]);
        hi = fmaxf(hi, b.z[j]);
      }
    }
  }
  int4* keys4 = reinterpret_cast<int4*>(keys);
  for (int i = threadIdx.x; i < rows * stride / 4; i += kThreads)
    keys4[i] = make_int4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      lo = fminf(lo, s_lo[i]);
      hi = fmaxf(hi, s_hi[i]);
    }
    s_part[0] = lo;
    s_part[1] = hi;
  }
  cluster_barrier(ctas);
  if (threadIdx.x == 0) {
    for (unsigned r = 0; r < ctas; ++r) {
      const float* part = cluster.map_shared_rank(s_part, r);
      lo = fminf(lo, part[0]);
      hi = fmaxf(hi, part[1]);
    }
    // an env with no valid point: zmin = +inf, zrange = 1e-3
    s_scale[0] = lo;
    s_scale[1] = fmaxf(__fsub_rn(hi, lo), static_cast<float>(1e-3));
  }
  __syncthreads();
  const float zmin = s_scale[0];
  const float zrange = s_scale[1];
  if (threadIdx.x <= kEmptyKey) {            // read after the next barrier
    const float d = decode(threadIdx.x, zmin, zrange, footprint, depth_max);
    s_depth[threadIdx.x] = d;
    s_depth16[threadIdx.x] = __bfloat162float(__float2bfloat16_rn(d));
  }

  // 2. each valid point's key, min-ed into the band that holds its pixel
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (held.slot[j] >= 0)
      key_min(cluster, keys, rank, held.slot[j],
              point_key(held.z[j], zmin, zrange));
  for (int base = first + kStep; base < p1; base += kStep) {
    const Batch b = load_batch(vi, ui, z, ok, pts, base, p1, h, w, band, stride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (b.slot[j] >= 0)
        key_min(cluster, keys, rank, b.slot[j], point_key(b.z[j], zmin, zrange));
  }
  cluster_barrier(ctas);

  // 3. the (2f+1)^2 min-pool on keys packed four to a word, one byte each:
  // the keys into `packed` ...
  const int f = footprint;
  const int qpr = stride / 4;                // quads (words) a row
  const int quads = rows * qpr;
  unsigned* packed32 = reinterpret_cast<unsigned*>(packed);
  for (int i = threadIdx.x; i < quads; i += kThreads) {
    const int4 k = keys4[i];
    packed32[i] = k.x | k.y << 8 | k.z << 16 | k.w << 24;
  }
  __syncthreads();
  // ... their row mins into the key words, which nothing reads any more ...
  unsigned* rowmin32 = reinterpret_cast<unsigned*>(keys);
  for (QuadWalk q(qpr); q.i < quads; q.next()) {
    const unsigned* row = packed32 + q.i - q.c;
    unsigned m = packed32[q.i];
    for (int d = 1; d <= f; ++d)
      m = __vminu4(m, __vminu4(bytes_at(row, qpr, 4 * q.c - d),
                               bytes_at(row, qpr, 4 * q.c + d)));
    rowmin32[q.i] = m;
  }
  cluster_barrier(ctas);
  // ... then the column mins of the row mins, the neighbouring bands' edge
  // rows read through distributed shared memory: the pooled keys, into
  // `packed`, and their depths, to the z-buffer
  const unsigned* prev =
      rank > 0 ? cluster.map_shared_rank(rowmin32, rank - 1) : nullptr;
  const unsigned* next =
      rank + 1 < ctas ? cluster.map_shared_rank(rowmin32, rank + 1) : nullptr;
  for (QuadWalk q(qpr); q.i < quads; q.next()) {
    const int v = r0 + q.lr;
    unsigned m = kEmptyKey4;
    for (int r = max(v - f, 0) - r0; r <= min(v + f, h - 1) - r0; ++r) {
      const unsigned word = r < 0 ? prev[(r + band) * qpr + q.c]
                            : r < rows ? rowmin32[r * qpr + q.c]
                                       : next[(r - rows) * qpr + q.c];
      m = __vminu4(m, word);
    }
    packed32[q.i] = m;
  }
  arrive(ctas);
  const bool rows16 = w % 4 == 0;            // z-buffer rows 16-byte aligned
  float* zb = zbuf + n * h * w;
  for (QuadWalk q(qpr); q.i < quads; q.next()) {
    const unsigned m = packed32[q.i];
    const float d0 = s_depth[m & 0xff], d1 = s_depth[m >> 8 & 0xff];
    const float d2 = s_depth[m >> 16 & 0xff], d3 = s_depth[m >> 24];
    float* out = zb + static_cast<long long>(r0 + q.lr) * w + 4 * q.c;
    if (rows16) {
      *reinterpret_cast<float4*>(out) = make_float4(d0, d1, d2, d3);
    } else {
      const int left = w - 4 * q.c;          // pixels of the quad in the row
      out[0] = d0;
      if (left > 1) out[1] = d1;
      if (left > 2) out[2] = d2;
      if (left > 3) out[3] = d3;
    }
  }
  wait(ctas);

  // 4. visibility against the pooled key at the point's pixel
  const float hundredth = 0.01f;             // float32 reciprocal of 100
  const float eps = __fadd_rn(__ldg(voxel_eps + n),
                              __fmul_rn(zrange, hundredth));
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int k = first + j * kThreads;
    if (k < p1) {
      const int slot = held.slot[j];
      visible[pts + k] =
          slot >= 0 && held.z[j] <= __fadd_rn(s_depth16[pooled_key(
                                       cluster, packed, rank, slot)], eps);
    }
  }
  for (int base = first + kStep; base < p1; base += kStep) {
    const Batch b = load_batch(vi, ui, z, ok, pts, base, p1, h, w, band, stride);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = base + j * kThreads;
      if (k < p1) {
        const int slot = b.slot[j];
        visible[pts + k] =
            slot >= 0 && b.z[j] <= __fadd_rn(s_depth16[pooled_key(
                                      cluster, packed, rank, slot)], eps);
      }
    }
  }
  // no CTA leaves while another may still read its shared memory; the
  // loads from the others' have returned, and nothing else needs ordering
  if (ctas > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    wait(ctas);
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
  err = cudaFuncGetAttributes(&attr, zbuf_visible_cluster_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(zbuf_visible_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// vi, ui [n, q] int32 (in range), z [n, q] float32, ok [n, q] bool (one
// byte each), voxel_eps [n] float32; outputs zbuf [n, h * w] float32 and
// visible [n, q] bool.  All contiguous on the current device; n > 0.
// `ctas` CTAs per env (1 to 8; ceil(h / ctas) >= footprint when ctas > 1),
// each with 5 * ceil(h / ctas) * (w rounded up to a multiple of 4) bytes of
// dynamic shared memory.  Launches the
// kernel once on `stream` and returns the launch's error, else
// cudaGetLastError() (0 on success); a cluster that cannot be scheduled is
// an error.  It does not synchronise.
extern "C" int zbuf_visible(const int* vi, const int* ui, const float* z,
                            const uint8_t* ok, const float* voxel_eps,
                            float* zbuf, uint8_t* visible, int n, int q,
                            int h, int w, int footprint, float depth_max,
                            int ctas, void* stream) {
  const int band = (h + ctas - 1) / ctas;
  const size_t smem = size_t{5} * band * ((w + 3) & ~3);
  cudaError_t err = allow_full_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ctas;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, zbuf_visible_cluster_kernel, vi, ui, z, ok,
                           voxel_eps, zbuf, visible, q, h, w, band, footprint,
                           depth_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
