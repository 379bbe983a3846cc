// Mamba-1 selective scan (forward) for Hopper (sm_90a), in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (mamba_scan, pl.pallas_call at :72, body _kernel at :28). For every batch
// row b and channel c, from h = 0:
//
//   h_t[n] = exp(dt_t[c] * A[c,n]) * h_{t-1}[n] + (dt_t[c] * u_t[c]) * B_t[n]
//   y_t[c] = sum_n h_t[n] * C_t[n] + D[c] * u_t[c]
//
// and writes y (B, L, Di) and the final state h_last (B, Di, N). The TPU
// kernel emits y only, and its wrapper recomputes h_last by running the
// whole recurrence again through the reference; here h_last is written
// from the state the scan carries.
//
// Design. The TPU's sequential chunk grid dimension becomes a loop over L
// inside a block. A block of 64 threads owns 64 channels of one batch row,
// one thread per channel, and keeps that channel's N states and A row in
// registers, in fp32 (N is a template bound: 4, 8, 16, 32 or 64; states
// beyond N stay 0). Time runs in chunks of 32 steps: the block stages the
// chunk's u and dt (coalesced along channels) and its B_t and C_t rows
// (shared by every channel of the row) in shared memory, then each thread
// runs its 32 steps from there. D*u is folded into the store of y. Ragged
// L and Di are masked in the kernel: nothing is padded, and nothing past L
// or Di is read. exp is the accurate expf, not __expf.
//
// What bounds it. At the serving shape (B=4, L=2048, Di=8192, N=16) the
// scan reads u and dt and writes y, 0.8 GB in fp32, against about 6 GFLOP:
// bytes bound it, at 0.24 ms on HBM3. Parallelism is one thread per
// (batch, channel), 32768 threads, about 8 warps per SM, and each thread
// walks 2048 dependent steps of 16 exps; PERF.md has the measured time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 32;     // time steps staged per round

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ D,
                  float* __restrict__ y, float* __restrict__ h_last, int L,
                  int Di, int N) {
  __shared__ float us[kChunk][kThreads];
  __shared__ float dts[kChunk][kThreads];
  __shared__ float bs[kChunk][NMAX];
  __shared__ float cs[kChunk][NMAX];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const bool live = ch < Di;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = live && n < N ? A[static_cast<long long>(ch) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float d_skip = live ? D[ch] : 0.f;
  const long long row0 = static_cast<long long>(b) * L;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int nt = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = 0; t < nt; ++t) {
      const long long idx = (row0 + t0 + t) * Di + ch;
      us[t][tid] = live ? u[idx] : 0.f;
      dts[t][tid] = live ? dt[idx] : 0.f;
    }
    for (int i = tid; i < kChunk * NMAX; i += kThreads) {
      const int t = i / NMAX;
      const int n = i - t * NMAX;
      float bv = 0.f, cv = 0.f;
      if (t < nt && n < N) {
        const long long idx = (row0 + t0 + t) * N + n;
        bv = Bm[idx];
        cv = Cm[idx];
      }
      bs[t][n] = bv;
      cs[t][n] = cv;
    }
    __syncthreads();  // chunk staged
    if (!live) continue;
    for (int t = 0; t < nt; ++t) {
      const float ut = us[t][tid];
      const float dtt = dts[t][tid];
      const float du = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        h[n] = expf(dtt * a[n]) * h[n] + du * bs[t][n];
        acc += h[n] * cs[t][n];
      }
      y[(row0 + t0 + t) * Di + ch] = acc + d_skip * ut;
    }
  }
  if (live) {
    float* hl = h_last + (static_cast<long long>(b) * Di + ch) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hl[n] = h[n];
  }
}

template <int NMAX>
int launch(const float* u, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, float* y, float* h_last, int B,
           int L, int Di, int N, cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<NMAX><<<grid, kThreads, 0, stream>>>(
      u, dt, A, Bm, Cm, D, y, h_last, L, Di, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u, dt (B, L, Di); A (Di, N); Bm, Cm (B, L, N); D (Di,); outputs y
// (B, L, Di) and h_last (B, Di, N): all fp32 and contiguous, N <= 64.
// Launches on `stream` and returns cudaGetLastError().
int mamba_scan_fwd(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D, void* y,
                   void* h_last, int B, int L, int Di, int N, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || N <= 0 || N > 64 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* uf = static_cast<const float*>(u);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(D);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 8) return launch<8>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 16)
    return launch<16>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 32)
    return launch<32>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  return launch<64>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
