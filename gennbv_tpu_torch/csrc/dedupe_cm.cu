// The report's 1 cm dedupe of each env's episode scan, for Hopper
// (sm_90a): two kernels around one sort of int64 keys, which PyTorch does
// between them (ops/dedupe.py).
//
// For every env e, the points of pts [T1, N, S, 3] (view 0 first) with
// valid[t, e, i] set, in the views that count -- view 0 always, view t >= 1
// where t - 1 <= first_done[e], the rule of algo/evaluation.py's
// before_done_mask -- are rounded to 1 cm and deduplicated:
//   out[e, :count[e]] = np.unique(np.round(points, 2), axis=0),
// the rows in np.unique's order; the rest of out[e] is not written (the
// wrapper zeroes the padding it keeps).  This is
// ops/chamfer.py's dedupe_round_cm, np.unique on the host, as the JAX
// package runs it (gennbv_tpu/ops/chamfer.py): there is no TPU kernel of
// it.  np.unique sorts rows of three float32s and its host pass took
// ~0.8-0.9 s an episode of the 400^2 report (50 envs x 31 views x 2,500
// rays), with the card idle.
//
// The rounding is NumPy's in float32: r = rint(x * 100) with the product
// rounded to nearest, and a row's value r / 100 divided to nearest
// (__fmul_rn, rintf, __fdiv_rn: no contraction can move a bit).  Two
// points give the same rounded row exactly when their integer centimetres
// r are equal, and r / 100 rises with r, so one int64 key a point
//   key = e << 3b | (rx + 2^(b-1)) << 2b | (ry + 2^(b-1)) << b | (rz + 2^(b-1))
// sorts each env's rows into np.unique's order (x, then y, then z) and
// the envs one after the other.  The env takes N's bit length in bits, so
// no env's key reaches the masked points' INT64_MAX, and the three axes b =
// (63 - those bits) / 3 bits each: 19 at 50 envs, +-2.6 km.  A valid
// point that is not finite or lies beyond +-2^(b-1) cm raises in the
// wrapper (counted here as "bad"), never a key that wraps.  The one
// difference from np.unique: a row rounded to -0.0 comes out +0.0, which
// changes no distance.
//
// What bounds it on an H100: bytes, and the sort.  The least work is every
// point's mask read (1 B), each counted point read (12 B) and each row
// written (12 B) once (ops/dedupe.py::work: ~4 MB of masks and under
// 10 MB of points an episode of the report, a few microseconds at
// 3.35 TB/s); the keys (8 B a point slot, ~31 MB) go through PyTorch's
// radix sort, which takes most of a call.  So:
//   - the key kernel takes one (view, env) row a CTA: its points are
//     contiguous and share the view's mask rule; each thread keys points,
//     and the CTA writes the row's count of keyed (and of bad) points, no
//     atomics;
//   - after the sort each env's keys are one contiguous segment, which
//     begins past the keys of the envs before it: the emit kernel gives
//     each env a CTA, which finds its segment from those counts and walks
//     it in tiles of 4,096 keys, 8 consecutive keys a thread; the first key
//     of each run of equal keys is a row, written at its rank among its
//     env's runs (a block scan of the tile's run starts, carried across
//     tiles), decoded from the key alone (the sort moves keys only);
//   - each CTA writes its env's count, its valid points and its bad ones
//     to `info`, which the wrapper copies to the host once: the call's one
//     wait.
#include <cuda_runtime.h>

namespace {

constexpr int kKeyThreads = 256;
constexpr int kEmitThreads = 512;
constexpr int kPerThread = 8;                          // keys a thread a tile
constexpr int kTile = kEmitThreads * kPerThread;       // 4,096 keys
constexpr long long kMasked = 0x7fffffffffffffffLL;    // INT64_MAX
constexpr unsigned kFull = 0xffffffffu;

// the sum of v over the CTA's kThreads threads, in every thread;
// `scratch` holds a value a warp
template <int kThreads, typename T>
__device__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();  // the scratch's last readers done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

// the sum of v over the threads before this one in the CTA, and in
// `total` over all of them
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // the scratch's last readers done
  if (lane == 31) scratch[threadIdx.x >> 5] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kEmitThreads / 32; ++w) {
    const int x = scratch[w];
    before += w < static_cast<int>(threadIdx.x >> 5) ? x : 0;
    sum += x;
  }
  *total = sum;
  return before + incl - v;
}

// NumPy's np.round(x, 2) in float32, before its division: rint(x * 100)
__device__ __forceinline__ float centimetres(float x) {
  return rintf(__fmul_rn(x, 100.0f));
}

// -lim <= r < lim (false for a NaN)
__device__ __forceinline__ bool in_range(float r, float lim) {
  return r >= -lim && r < lim;
}

__global__ void __launch_bounds__(kKeyThreads)
    dedupe_key_kernel(const float* __restrict__ pts,
                      const unsigned char* __restrict__ valid,
                      const long long* __restrict__ first_done,
                      long long* __restrict__ keys,
                      int* __restrict__ row_counts, int n, int s, int bits) {
  __shared__ int scratch[kKeyThreads / 32];
  const int row = blockIdx.x;                  // view t, env e
  const int t = row / n, e = row - t * n;
  const bool counts = t == 0 || static_cast<long long>(t - 1) <= first_done[e];
  const long long half = 1LL << (bits - 1);
  const float lim = static_cast<float>(half);
  const long long env_key = static_cast<long long>(e) << (3 * bits);
  const long long base = static_cast<long long>(row) * s;
  int good = 0, bad = 0;
  for (int i = threadIdx.x; i < s; i += kKeyThreads) {
    long long key = kMasked;
    if (counts && valid[base + i]) {
      const float* p = pts + 3 * (base + i);
      const float rx = centimetres(p[0]);
      const float ry = centimetres(p[1]);
      const float rz = centimetres(p[2]);
      if (in_range(rx, lim) && in_range(ry, lim) && in_range(rz, lim)) {
        key = env_key
              | ((static_cast<long long>(rx) + half) << (2 * bits))
              | ((static_cast<long long>(ry) + half) << bits)
              | (static_cast<long long>(rz) + half);
        ++good;
      } else {
        ++bad;
      }
    }
    keys[base + i] = key;
  }
  good = block_sum<kKeyThreads>(good, scratch);
  bad = block_sum<kKeyThreads>(bad, scratch);
  if (threadIdx.x == 0) {
    row_counts[row] = good;
    row_counts[gridDim.x + row] = bad;
  }
}

__global__ void __launch_bounds__(kEmitThreads)
    dedupe_emit_kernel(const long long* __restrict__ sorted,
                       const int* __restrict__ row_counts,
                       float* __restrict__ out, int* __restrict__ info, int n,
                       int rows, long long cap, int bits) {
  __shared__ long long scratch64[kEmitThreads / 32];
  __shared__ int scratch[kEmitThreads / 32];
  const int e = blockIdx.x;
  // the env's segment of the sorted keys: past every keyed point of the
  // envs before it (the masked keys sort last)
  long long before = 0;
  int keyed = 0, bad = 0;
  for (int r = threadIdx.x; r < rows; r += kEmitThreads) {
    const int env = r % n;
    if (env < e) {
      before += row_counts[r];
    } else if (env == e) {
      keyed += row_counts[r];
      bad += row_counts[rows + r];
    }
  }
  const long long begin = block_sum<kEmitThreads>(before, scratch64);
  keyed = block_sum<kEmitThreads>(keyed, scratch);
  bad = block_sum<kEmitThreads>(bad, scratch);
  const long long end = begin + keyed;
  const long long field = (1LL << bits) - 1, half = 1LL << (bits - 1);
  float* env_out = out + 3 * cap * e;
  int kept = 0;  // the env's rows so far, the same in every thread
  for (long long t0 = begin; t0 < end; t0 += kTile) {
    const long long i0 = t0 + static_cast<long long>(threadIdx.x) * kPerThread;
    long long key[kPerThread];
    unsigned starts = 0;  // bit j: key j begins a run
    if (i0 < end) {
      long long prev = i0 > begin ? sorted[i0 - 1] : -1;  // keys are >= 0
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (i0 + j < end) {
          key[j] = sorted[i0 + j];
          starts |= static_cast<unsigned>(key[j] != prev) << j;
          prev = key[j];
        }
      }
    }
    int total;
    int rank = kept + block_exclusive_scan(__popc(starts), &total, scratch);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if ((starts >> j) & 1u) {
        float* row = env_out + 3LL * rank++;
        row[0] = __fdiv_rn(static_cast<float>(((key[j] >> (2 * bits)) & field) - half), 100.0f);
        row[1] = __fdiv_rn(static_cast<float>(((key[j] >> bits) & field) - half), 100.0f);
        row[2] = __fdiv_rn(static_cast<float>((key[j] & field) - half), 100.0f);
      }
    }
    kept += total;
  }
  if (threadIdx.x == 0) {
    info[e] = kept;
    info[n + e] = keyed + bad;
    info[2 * n + e] = bad;
  }
}

}  // namespace

// pts [t1, n, s, 3] float32, valid [t1, n, s] uint8 (nonzero: valid),
// first_done [n] int64, keys [t1 * n * s] int64 and row_counts [2, t1 * n]
// int32 (both written in full), all contiguous on the current device; bits
// the key's bits an axis (ops/dedupe.py::key_bits(n)).  Launches the key
// kernel once on `stream` and returns cudaGetLastError() (0 on success).
// It does not synchronise.
extern "C" int dedupe_cm_keys(const float* pts, const unsigned char* valid,
                              const long long* first_done, long long* keys,
                              int* row_counts, int t1, int n, int s, int bits,
                              void* stream) {
  if (t1 <= 0 || n <= 0 || s <= 0 || bits < 1 || bits > 20)
    return static_cast<int>(cudaErrorInvalidValue);
  dedupe_key_kernel<<<t1 * n, kKeyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      pts, valid, first_done, keys, row_counts, n, s, bits);
  return static_cast<int>(cudaGetLastError());
}

// sorted: the key kernel's keys in ascending order; row_counts its counts;
// out [n, cap, 3] float32, each env's rows written from its start and the
// rest left as it was, and info [3, n] int32 (each env's rows, valid
// points and bad points), written in full; cap at least each env's
// t1 * s points.  Launches the emit kernel once on `stream` and returns
// cudaGetLastError().  It does not synchronise.
extern "C" int dedupe_cm_emit(const long long* sorted, const int* row_counts,
                              float* out, int* info, int t1, int n,
                              long long cap, int bits, void* stream) {
  if (t1 <= 0 || n <= 0 || cap < 0 || bits < 1 || bits > 20)
    return static_cast<int>(cudaErrorInvalidValue);
  dedupe_emit_kernel<<<n, kEmitThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      sorted, row_counts, out, info, n, t1 * n, cap, bits);
  return static_cast<int>(cudaGetLastError());
}
