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
// Design. The TPU version turned both gathers into one-hot MXU matmuls;
// here they are plain gathers and compares, with no tensor cores. One
// thread owns one row: the block's rows of X are staged in shared memory
// feature-major (every thread of a tree reads the same feature, so a warp
// reads consecutive words), and the trees are staged through shared memory
// in tiles (feats int32, thresholds and leaves fp64) sized on the host to
// fit 48 KB of dynamic shared memory. Ragged n and T are masked inside the
// kernel; the wrapper does not pad.
//
// Summation order. Each thread sums its row's leaves in fp64 in exactly
// the order numpy's pairwise sum uses for the reference's
// ``contrib.sum(axis=1)``: blocks of at most 128 trees, each summed with 8
// interleaved accumulators (remainder added last), combined along the
// binary split tree that numpy's recursion draws. The host encodes that
// tree for T as a post-order program (a positive entry is a block of that
// many trees, 0 adds the top two partial sums); the thread walks the trees
// in ascending order and runs the program on a small stack. Every block
// starts at a multiple of 8 trees and tiles hold a multiple of 8 trees, so
// accumulator j always takes tree 8k + j and stays in a register. The
// plain PyTorch version (repro_torch/kernels/ref.py) runs the same order,
// so kernel, plain version and the reference's numpy predict agree bit for
// bit — which is what lets the scheduler's records match exactly.
//
// What bounds it. On the scheduler's main path the kernel evaluates 768
// rows x 400 trees per regressor (a prefetch batch) or a single row (a
// point prediction): about 0.2 MB to move and 1.5 M compares and adds,
// well under a microsecond at the card's memory and fp64 rates. Neither
// bytes nor operations bound it: launch latency, the host's cost to issue
// a call, each block staging the whole ensemble, and each thread's serial
// walk over every tree do. The design keeps one launch per batch and no
// host synchronisation in the wrapper; PERF.md has the measured times. A
// faster version would split a row's trees across the warps of a block
// (numpy's pairwise blocks are independent partial sums) and stage the
// ensemble once per SM rather than once per block.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;               // rows (threads) per block
constexpr int kMaxDepth = 8;
constexpr int kMaxStack = 32;           // pairwise partial sums in flight
constexpr int kSmemBytes = 48 * 1024;   // no opt-in needed below this

__device__ __forceinline__ double combine8(const double (&r)[8]) {
  return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
}

template <int D>
__global__ void __launch_bounds__(kRows)
gbdt_predict_kernel(const double* __restrict__ X,
                    const int* __restrict__ feats,
                    const double* __restrict__ thr,
                    const double* __restrict__ leaves,
                    const int* __restrict__ prog, int prog_len,
                    double base, double* __restrict__ out,
                    int n, int F, int T, int tile) {
  constexpr int kLeaves = 1 << D;
  extern __shared__ __align__(16) unsigned char smem[];
  double* xs = reinterpret_cast<double*>(smem);        // F x kRows
  double* lv = xs + F * kRows;                          // tile x kLeaves
  double* th = lv + tile * kLeaves;                     // tile x D
  int* ft = reinterpret_cast<int*>(th + tile * D);      // tile x D

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        n - row0));
  const double* xb = X + row0 * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F;
    xs[(i - r * F) * kRows + r] = xb[i];
  }

  // pairwise-sum state: current block length L, position p in it, the
  // end of its 8-accumulator body, the accumulators, and the stack
  double stack[kMaxStack];
  int sp = 0;
  int pc = 0;
  int L = prog_len > 0 ? prog[pc++] : 0;
  int body = L - (L & 7);
  int p = 0;
  double acc[8];
  double res = 0.0;
  bool bad_feature = false;

  const int r = threadIdx.x;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int nt = min(tile, T - t0);
    __syncthreads();  // X staged; the previous tile fully consumed
    const double* lsrc = leaves + static_cast<long long>(t0) * kLeaves;
#pragma unroll 4
    for (int i = threadIdx.x; i < nt * kLeaves; i += blockDim.x) {
      lv[i] = lsrc[i];
    }
    const long long off = static_cast<long long>(t0) * D;
#pragma unroll 4
    for (int i = threadIdx.x; i < nt * D; i += blockDim.x) {
      th[i] = thr[off + i];
      ft[i] = feats[off + i];
    }
    __syncthreads();
    if (r >= rows) continue;
    for (int t8 = 0; t8 < nt; t8 += 8) {
      const int m = min(8, nt - t8);
      // eight independent tree walks first, so their loads overlap ...
      double v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t8 + (j < m ? j : 0);
        int idx = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int f = ft[t * D + d];
          bad_feature |= static_cast<unsigned>(f) >=
                         static_cast<unsigned>(F);
          const double x = xs[min(max(f, 0), F - 1) * kRows + r];
          idx |= static_cast<int>(x > th[t * D + d]) << d;
        }
        v[j] = lv[t * kLeaves + idx];
      }
      // ... then the sums, in numpy's order
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= m) break;
        if (L < 8) {
          res += v[j];
        } else if (p < 8) {
          acc[j] = v[j];       // p == j: blocks start at multiples of 8
        } else if (p < body) {
          acc[j] += v[j];
        } else {
          if (p == body) res = combine8(acc);
          res += v[j];
        }
        if (++p == L) {        // block done: push it, run the adds
          if (L >= 8 && body == L) res = combine8(acc);
          stack[sp++] = res;
          while (pc < prog_len && prog[pc] == 0) {
            const double b = stack[--sp];
            const double a = stack[--sp];
            stack[sp++] = a + b;
            ++pc;
          }
          if (pc < prog_len) {
            L = prog[pc++];
            body = L - (L & 7);
          }
          p = 0;
          res = 0.0;
        }
      }
    }
  }
  if (r < rows) {
    // numpy's reduction starts from 0.0; a feature index outside [0, F)
    // poisons the row instead of reading out of bounds
    const double total = 0.0 + (prog_len > 0 ? stack[0] : 0.0);
    out[row0 + r] = bad_feature ? __longlong_as_double(0x7ff8000000000000LL)
                                : base + total;
  }
}

template <int D>
void launch_depth(const double* X, const int* feats, const double* thr,
                  const double* leaves, const int* prog, int prog_len,
                  double base, double* out, int n, int F, int T, int tile,
                  size_t smem, cudaStream_t stream) {
  const int blocks = (n + kRows - 1) / kRows;
  gbdt_predict_kernel<D><<<blocks, kRows, smem, stream>>>(
      X, feats, thr, leaves, prog, prog_len, base, out, n, F, T, tile);
}

}  // namespace

extern "C" {

// The largest tree tile (a multiple of 8) that fits beside the block's rows
// of X in shared memory; 0 when not even 8 trees fit.
int gbdt_predict_tile(int F, int depth) {
  const long long per_tree = (8LL << depth) + 12LL * depth;
  const long long room = kSmemBytes - 8LL * F * kRows;
  if (room < 8 * per_tree) return 0;
  return static_cast<int>(room / per_tree) & ~7;
}

// Launches the kernel on `stream` and returns cudaGetLastError(): a launch
// the runtime refuses never runs, and a later synchronize would not say so.
int gbdt_predict_f64(const void* X, const void* feats, const void* thr,
                     const void* leaves, const void* prog, int prog_len,
                     double base, void* out, int n, int F, int T, int depth,
                     void* stream) {
  if (n <= 0 || F <= 0 || T < 0 || depth < 0 || depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_max = gbdt_predict_tile(F, depth);
  if (tile_max < 8) return static_cast<int>(cudaErrorInvalidValue);
  const int t_up = (T + 7) & ~7;
  const int tile = t_up < 8 ? 8 : (t_up < tile_max ? t_up : tile_max);
  const size_t smem = 8ull * F * kRows
                      + static_cast<size_t>(tile) * ((8ull << depth)
                                                      + 12ull * depth);
  const double* x = static_cast<const double*>(X);
  const int* f = static_cast<const int*>(feats);
  const double* th = static_cast<const double*>(thr);
  const double* lv = static_cast<const double*>(leaves);
  const int* pr = static_cast<const int*>(prog);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {  // depth is a template argument: tree walks unroll
#define GBDT_DEPTH(D)                                                    \
    case D:                                                              \
      launch_depth<D>(x, f, th, lv, pr, prog_len, base, o, n, F, T, tile, \
                      smem, s);                                          \
      break;
    GBDT_DEPTH(0) GBDT_DEPTH(1) GBDT_DEPTH(2) GBDT_DEPTH(3) GBDT_DEPTH(4)
    GBDT_DEPTH(5) GBDT_DEPTH(6) GBDT_DEPTH(7) GBDT_DEPTH(8)
#undef GBDT_DEPTH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gbdt_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
