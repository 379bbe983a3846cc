// Oblivious-tree GBDT ensemble inference for Hopper (sm_90a), in fp64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdt_predict.py
// (gbdt_predict, pl.pallas_call at :90, body _kernel at :44). It computes
//
//   out[n] = base + sum_t leaves[t, sum_d [X[n, feats[t,d]] > thr[t,d]] << d]
//
// for an ensemble of T oblivious trees of depth D <= 8 over F features.
// Padded trees carry +inf thresholds (every bit 0) and zero leaves.
//
// Summation order. A row's leaves are summed in fp64 in exactly the order
// numpy's pairwise sum uses for the reference's ``contrib.sum(axis=1)``, so
// kernel, plain version (repro_torch/kernels/ref.py) and the reference's
// numpy predict agree bit for bit, which lets the scheduler's records match
// exactly. That order is a set of independent chains (ref.lane_schedule):
// numpy sums T >= 8 terms in blocks of 8..128 terms, each block as 8
// interleaved accumulators (chain j takes the block's terms j, j + 8, ...
// of its body), combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the
// block's L % 8 remainder terms in order; the block sums are combined along
// numpy's recursion (the schedule's pair program). Below 8 terms it is one
// running sum from 0.0.
//
// Design. Neither bytes nor operations bound it: on the scheduler's main
// path the kernel evaluates 768 rows x 400 trees of depth 4 per regressor (a
// prefetch batch) or a single row, about 0.2 MB to move and 1.5 M compares
// and adds, well under a microsecond at the card's memory and fp64 rates.
// Latency does: the launch, and the chain of dependent loads per tree
// (feature index, then the row's X, then the leaf) times the trees a thread
// walks in series. So a row's chains run on separate lanes: a group of G
// lanes (a power of two >= 8, chosen by the wrapper from the chain count,
// the batch and the SM count) owns a row, lane l sums chains l, l + G, ...
// of it, unrolled 8 trees at a time (4 past depth 4; the compiler keeps
// fewer of their loads in flight, PERF.md). The 8 chains of a block sit on 8
// aligned lanes and are combined by xor-shuffles over 1, 2 and 4 lanes,
// which reproduce numpy's grouping exactly (IEEE addition commutes); the
// remainder terms, evaluated by the block's first lanes, are shuffled to
// every lane and added in order. Each block's first lane writes its sum to
// shared memory, and the row's first lane runs the pair program there. No
// atomics: nothing depends on timing. A chain's trees sit 8 apart, so
// neighbouring lanes read neighbouring trees: the ensemble (70 KB at the
// main shape) is read through the read-only path straight from L1 and L2,
// with no block-wide stage, no __syncthreads per tile and no shared-memory
// limit on T. The row group's X (F doubles) is staged in shared memory and
// gathered from there, the index clamped. Blocks hold 128 threads (or one
// group, if wider), so 768 rows of 32 lanes are 192 blocks over the 132 SMs.
// The main shape then takes about 6-9 times an empty kernel's launch
// (PERF.md). For very large batches the wrapper gives a row one lane (G =
// 1), which walks the row's blocks with the 8 chains in registers, as the
// previous kernel did: every lane of a warp then reads the same tree, so the
// load instructions serve 32 rows, which pays once load throughput, not
// latency, is the limit. A feature index outside [0, F) makes its tree's
// leaf NaN, which poisons the row; the index is never used unclamped.
// (Staging the ensemble in shared memory once per SM instead was measured
// slower from 1 to 768 rows, where a block copies 70 KB before its first
// tree, and faster from 4096; PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kThreads = 128;          // threads per block, unless G is wider
constexpr int kMaxGroup = 1024;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in needed below this
constexpr unsigned kFull = 0xffffffffu;

// Tree t's leaf for the row whose features sit at xs; NaN when the tree
// names a feature outside [0, F) (the gather is clamped, never out of
// bounds).
template <int D>
__device__ __forceinline__ double tree_leaf(int t, const double* xs,
                                            const int* feats,
                                            const double* thr,
                                            const double* leaves, int F) {
  int idx = 0;
  bool bad = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int f = __ldg(feats + t * D + d);
    bad |= static_cast<unsigned>(f) >= static_cast<unsigned>(F);
    const double x = xs[min(max(f, 0), F - 1)];
    idx |= static_cast<int>(x > __ldg(thr + t * D + d)) << d;
  }
  const double v = __ldg(leaves + (static_cast<long long>(t) << D) + idx);
  return bad ? __longlong_as_double(0x7ff8000000000000LL) : v;
}

// acc + the leaves of trees first, first + stride, ... (count of them),
// added in that order, kInFlight trees' loads issued together (fewer for
// deep trees, whose loads take more registers).
template <int D>
__device__ __forceinline__ double chain_sum(double acc, int first, int count,
                                            int stride, const double* xs,
                                            const int* feats,
                                            const double* thr,
                                            const double* leaves, int F) {
  constexpr int kInFlight = D <= 4 ? 8 : 4;
  for (int k = 0; k < count; k += kInFlight) {
    double v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int t = first + min(k + u, count - 1) * stride;
      v[u] = tree_leaf<D>(t, xs, feats, thr, leaves, F);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (k + u < count) acc += v[u];
    }
  }
  return acc;
}

// A pairwise block of len >= 8 trees from `start` summed by one lane: the
// 8 chains in registers, combined in numpy's grouping, then the remainder.
template <int D>
__device__ __forceinline__ double block_sum(int start, int len,
                                            const double* xs,
                                            const int* feats,
                                            const double* thr,
                                            const double* leaves, int F) {
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = -0.0;
  const int end = start + (len & ~7);
  for (int t = start; t < end; t += 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = tree_leaf<D>(t + j, xs, feats, thr, leaves, F);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += v[j];
  }
  double acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) +
                                                  (r[6] + r[7]));
  for (int t = end; t < start + len; ++t) {
    acc += tree_leaf<D>(t, xs, feats, thr, leaves, F);
  }
  return acc;
}

// sched: (first tree, length) of each of n_blocks pairwise blocks, then
// n_pairs (a, b) slot pairs (ref.lane_schedule). Block threads are a
// multiple of 32 and of `group`; group is 1 (a lane walks the row's blocks
// with the 8 chains in registers) or, for T >= 8, a power of two >= 8
// (lanes take the chains in turns, shuffle-combined).
template <int D>
__global__ void gbdt_predict_kernel(const double* __restrict__ X,
                                    const int* __restrict__ feats,
                                    const double* __restrict__ thr,
                                    const double* __restrict__ leaves,
                                    const int* __restrict__ sched,
                                    int n_blocks, int n_pairs, double base,
                                    double* __restrict__ out, int n, int F,
                                    int T, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = n_blocks + n_pairs;
  const int rows = blockDim.x / group;     // row groups per block
  const int g = threadIdx.x / group;
  const int lane = threadIdx.x - g * group;
  double* xs_all = reinterpret_cast<double*>(smem);         // rows x F
  double* xs = xs_all + g * F;
  double* sums = xs_all + rows * F + g * slots;             // rows x slots
  const int chains = T >= 8 ? 8 * n_blocks : min(T, 1);
  const int rounds = (chains + group - 1) / group;
  const int first_lane = (threadIdx.x & 31) & ~7;   // of this lane's 8
  const long long row = static_cast<long long>(blockIdx.x) * rows + g;
  const bool live = row < n;

  const long long x0 = static_cast<long long>(blockIdx.x) * rows * F;
  const long long x_len = min(static_cast<long long>(n) * F - x0,
                              static_cast<long long>(rows) * F);
  for (long long i = threadIdx.x; i < x_len; i += blockDim.x) {
    xs_all[i] = X[x0 + i];
  }
  __syncthreads();
  if (group == 1 && live) {   // one lane walks the whole row
    if (chains == 1) {         // numpy starts the single chain from 0.0
      sums[0] = chain_sum<D>(0.0, 0, T, 1, xs, feats, thr, leaves, F);
    }
    for (int b = 0; chains >= 8 && b < n_blocks; ++b) {
      sums[b] = block_sum<D>(__ldg(sched + 2 * b), __ldg(sched + 2 * b + 1),
                             xs, feats, thr, leaves, F);
    }
  }
  for (int r = 0; group > 1 && r < rounds; ++r) {
    const int c = lane + r * group;
    const bool mine = live && c < chains;
    double acc = 0.0;
    double rem_leaf = 0.0;
    int rem = 0;
    if (mine) {
      const int start = __ldg(sched + 2 * (c >> 3));
      const int len = __ldg(sched + 2 * (c >> 3) + 1);
      const int j = c & 7;
      const int body = len & ~7;
      // -0.0 is the additive identity: the chain equals its first term
      acc = chain_sum<D>(-0.0, start + j, body >> 3, 8, xs, feats, thr,
                         leaves, F);
      rem = len - body;
      if (j < rem) {
        rem_leaf = tree_leaf<D>(start + body + j, xs, feats, thr, leaves, F);
      }
    }
    // every lane of the launch shuffles: groups are 8-lane aligned
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    acc += __shfl_xor_sync(kFull, acc, 4);
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const double v = __shfl_sync(kFull, rem_leaf, first_lane + i);
      if (i < rem) acc += v;
    }
    if (mine && (c & 7) == 0) sums[c >> 3] = acc;
  }
  __syncthreads();
  if (live && lane == 0) {
    double total = 0.0;
    if (slots > 0) {
      for (int k = 0; k < n_pairs; ++k) {
        const int* p = sched + 2 * (n_blocks + k);
        sums[n_blocks + k] = sums[__ldg(p)] + sums[__ldg(p + 1)];
      }
      total = sums[slots - 1];
    }
    // numpy's reduction adds its pairwise sum to an initial 0.0
    out[row] = base + (0.0 + total);
  }
}

__global__ void empty_kernel() {}

template <int D>
cudaError_t launch_depth(const double* X, const int* feats,
                         const double* thr, const double* leaves,
                         const int* sched, int n_blocks, int n_pairs,
                         double base, double* out, int n, int F, int T,
                         int group, cudaStream_t stream) {
  const int step = group > 32 ? group : 32;
  const long long per_row = 8LL * (F + n_blocks + n_pairs);
  int threads = group > kThreads ? group : kThreads;
  const auto smem = [&](int t) { return t / group * per_row; };
  while (smem(threads) > kSmemBytes && threads > step) threads -= step;
  if (smem(threads) > kSmemBytes) return cudaErrorInvalidValue;
  const int rows = threads / group;
  gbdt_predict_kernel<D>
      <<<(n + rows - 1) / rows, threads,
         static_cast<size_t>(smem(threads)), stream>>>(
          X, feats, thr, leaves, sched, n_blocks, n_pairs, base, out, n, F,
          T, group);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (or the
// configuration error found first): a launch the runtime refuses never
// runs, and a later synchronize would not say so. `group` lanes share a
// row: 1 (any T), or for T >= 8 a power of two from 8 to 1024.
int gbdt_predict_f64(const void* X, const void* feats, const void* thr,
                     const void* leaves, const void* sched, int n_blocks,
                     int n_pairs, double base, void* out, int n, int F,
                     int T, int depth, int group, void* stream) {
  const bool group_ok = group == 1 ||
                        (T >= 8 && group >= 8 && group <= kMaxGroup &&
                         (group & (group - 1)) == 0);
  if (n <= 0 || F <= 0 || T < 0 || depth < 0 || depth > kMaxDepth ||
      n_blocks < 0 || n_pairs < 0 || !group_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double* x = static_cast<const double*>(X);
  const int* f = static_cast<const int*>(feats);
  const double* th = static_cast<const double*>(thr);
  const double* lv = static_cast<const double*>(leaves);
  const int* sc = static_cast<const int*>(sched);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (depth) {  // depth is a template argument: tree walks unroll
#define GBDT_DEPTH(D)                                                     \
    case D:                                                               \
      e = launch_depth<D>(x, f, th, lv, sc, n_blocks, n_pairs, base, o, n, \
                          F, T, group, s);                                \
      break;
    GBDT_DEPTH(0) GBDT_DEPTH(1) GBDT_DEPTH(2) GBDT_DEPTH(3) GBDT_DEPTH(4)
    GBDT_DEPTH(5) GBDT_DEPTH(6) GBDT_DEPTH(7) GBDT_DEPTH(8)
#undef GBDT_DEPTH
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One empty kernel on `stream`: the card's launch floor, timed beside the
// kernel (chip_smoke.py phase 2).
int gbdt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* gbdt_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
