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
// What bounds it. At the serving shape (B=4, L=2048, Di=8192, N=16) the
// scan reads u and dt and writes y, 0.8 GB in fp32, against about 6 GFLOP:
// bytes bound it, at 0.24 ms on HBM3. Close behind are the 1.07e9 exps,
// one per state update, on the special-function units (16 a clock per SM:
// about 0.29 ms at the H100's boost clock). The first version ran one
// thread per (batch, channel): 32768 threads, about 8 warps per SM, each
// walking 2048 dependent steps, with its loads issued one time step at a
// time and no load in flight while it computed. It was latency-bound.
//
// Design. The TPU's sequential chunk grid dimension becomes a loop over L
// inside a block; the parallelism comes from splitting each channel's N
// states over lanes, not from a chunked scan over L: every input is still
// read once and no second pass combines chunk states. Each lane carries 8
// independent state chains, which hides the exp-FMA latency with fewer
// warps; at N = 16 the serving batch (B=4) gives 2x the threads of the
// first version (65536, 16 warps per SM). Measured at the serving shape,
// 2 lanes x 8 states ran faster than 4 x 4 (more threads, but more
// shared loads and shuffles per state) and than 1 x 16. B = 1 leaves a
// quarter of the warps; PERF.md has its time beside B = 4's.
//
// * A block owns 64 channels of one batch row. A channel's states are
//   split over LPC lanes of one warp, SPL = N / LPC states each (8, or N
//   below 8); A's row, pre-scaled by log2(e), and the states live in
//   registers. y_t is reduced over the LPC lanes by shuffles.
// * Time runs in chunks of 32 steps through a double buffer in shared
//   memory: cp.async stages the next chunk's u and dt (coalesced along
//   channels, 16 bytes a copy when Di is a multiple of 4 and the tensors
//   are aligned) and its B_t, C_t rows while the current chunk is
//   scanned. y goes through shared memory and out as coalesced rows, D*u
//   folded in.
// * Ragged L and Di are masked: the copies zero-fill past them, nothing
//   past L or Di is read or written, and nothing is padded.
// * exp(dt A) is ex2.approx.ftz(dt * (A log2 e)): one special-function
//   instruction, where expf costs that and about six more on the FMA
//   pipes; the scan is bound by instruction issue, so the count matters.
//   Against expf this adds the rounding of A log2 e (2^-24 relative in
//   the argument, under 2^-21 relative in the factor for |dt A| < 8) to
//   ex2's own 2-ulp error, the same order as expf's 2-ulp bound, and
//   flushes factors below 2^-126 to 0 (an absolute error under 1.2e-38).
//   F32_TOL = (2e-5, 2e-5) is unchanged; PERF.md records the measured
//   errors.

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;  // channels per block
constexpr int kChunk = 32;     // time steps staged per round
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One chunk's staging area: u, dt [kChunk][kChannels]; B, C
// [kChunk][NMAX].
template <int NMAX>
struct Stage {
  float u[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float b[kChunk][NMAX];
  float c[kChunk][NMAX];
};

template <int NMAX>
struct Shared {
  Stage<NMAX> buf[2];
  float y[kChunk][kChannels];
};

// Copy chunk [t0, t0 + nt) of batch row b into st; zeros past L and Di.
template <int NMAX, int kThreads>
__device__ __forceinline__ void stage_chunk(
    Stage<NMAX>& st, const float* __restrict__ u,
    const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, long long row0, int t0, int nt, int c0,
    int Di, int N, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kVecs = kChannels / 4;
    for (int i = tid; i < kChunk * kVecs; i += kThreads) {
      const int t = i / kVecs;
      const int j = 4 * (i - t * kVecs);
      const bool ok = t < nt && c0 + j < Di;
      const long long g = ok ? (row0 + t0 + t) * Di + c0 + j : 0;
      cp_async16(&st.u[t][j], u + g, ok);
      cp_async16(&st.dt[t][j], dt + g, ok);
    }
  } else {
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int t = i / kChannels;
      const int j = i - t * kChannels;
      const bool ok = t < nt && c0 + j < Di;
      const long long g = ok ? (row0 + t0 + t) * Di + c0 + j : 0;
      cp_async4(&st.u[t][j], u + g, ok);
      cp_async4(&st.dt[t][j], dt + g, ok);
    }
  }
  for (int i = tid; i < kChunk * NMAX; i += kThreads) {
    const int t = i / NMAX;
    const int n = i - t * NMAX;
    const bool ok = t < nt && n < N;
    const long long g = ok ? (row0 + t0 + t) * N + n : 0;
    cp_async4(&st.b[t][n], Bm + g, ok);
    cp_async4(&st.c[t][n], Cm + g, ok);
  }
}

template <int NMAX, int LPC>
__global__ void __launch_bounds__(kChannels * LPC)
mamba_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ D,
                  float* __restrict__ y, float* __restrict__ h_last, int L,
                  int Di, int N, int vec) {
  constexpr int kThreads = kChannels * LPC;
  constexpr int SPL = NMAX / LPC;            // states per lane
  static_assert(SPL % 4 == 0, "B and C rows are read as float4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<NMAX>& sm = *reinterpret_cast<Shared<NMAX>*>(smem_raw);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cl = tid / LPC;                  // channel within the block
  const int g = tid - cl * LPC;              // lane within the channel
  const int c0 = blockIdx.x * kChannels;
  const int ch = c0 + cl;
  const bool live = ch < Di;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = g * SPL + j;
    a2[j] = live && n < N ? A[static_cast<long long>(ch) * N + n] * kLog2e
                          : 0.f;
    h[j] = 0.f;
  }
  const float d_skip = live ? D[ch] : 0.f;
  const long long row0 = static_cast<long long>(b) * L;
  const int n_chunks = (L + kChunk - 1) / kChunk;

  stage_chunk<NMAX, kThreads>(sm.buf[0], u, dt, Bm, Cm, row0, 0,
                              min(kChunk, L), c0, Di, N, vec != 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int nt = min(kChunk, L - t0);
    if (k + 1 < n_chunks)   // the next chunk loads while this one is scanned
      stage_chunk<NMAX, kThreads>(sm.buf[(k + 1) & 1], u, dt, Bm, Cm, row0,
                                  t0 + kChunk, min(kChunk, L - t0 - kChunk),
                                  c0, Di, N, vec != 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();        // chunk k staged for every thread

    const Stage<NMAX>& st = sm.buf[k & 1];
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float ut = st.u[t][cl];
      const float dtt = st.dt[t][cl];
      const float du = dtt * ut;
      float bv[SPL], cv[SPL];
#pragma unroll
      for (int j = 0; j < SPL; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            &st.b[t][g * SPL + j]);
        const float4 c4 = *reinterpret_cast<const float4*>(
            &st.c[t][g * SPL + j]);
        bv[j] = b4.x; bv[j + 1] = b4.y; bv[j + 2] = b4.z; bv[j + 3] = b4.w;
        cv[j] = c4.x; cv[j + 1] = c4.y; cv[j + 2] = c4.z; cv[j + 3] = c4.w;
      }
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        h[j] = exp2_ftz(dtt * a2[j]) * h[j] + du * bv[j];
        acc += h[j] * cv[j];
      }
#pragma unroll
      for (int w = 1; w < LPC; w <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (g == 0) sm.y[t][cl] = acc + d_skip * ut;
    }
    __syncthreads();        // chunk k consumed; its y rows complete

    if (vec) {
      constexpr int kVecs = kChannels / 4;
      for (int i = tid; i < kChunk * kVecs; i += kThreads) {
        const int t = i / kVecs;
        const int j = 4 * (i - t * kVecs);
        if (t < nt && c0 + j < Di)
          *reinterpret_cast<float4*>(y + (row0 + t0 + t) * Di + c0 + j) =
              *reinterpret_cast<const float4*>(&sm.y[t][j]);
      }
    } else {
      for (int i = tid; i < kChunk * kChannels; i += kThreads) {
        const int t = i / kChannels;
        const int j = i - t * kChannels;
        if (t < nt && c0 + j < Di)
          y[(row0 + t0 + t) * Di + c0 + j] = sm.y[t][j];
      }
    }
  }
  if (live) {
    float* hl = h_last + (static_cast<long long>(b) * Di + ch) * N;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (g * SPL + j < N) hl[g * SPL + j] = h[j];
  }
}

template <int NMAX, int LPC>
int launch(const float* u, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, float* y, float* h_last, int B,
           int L, int Di, int N, cudaStream_t stream) {
  const size_t smem = sizeof(Shared<NMAX>);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<NMAX, LPC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies of u, dt and y: whole vectors along channels
  const auto bits = reinterpret_cast<unsigned long long>(u)
                    | reinterpret_cast<unsigned long long>(dt)
                    | reinterpret_cast<unsigned long long>(y);
  const int vec = Di % 4 == 0 && (bits & 15ull) == 0;
  const dim3 grid((Di + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<NMAX, LPC><<<grid, kChannels * LPC, smem, stream>>>(
      u, dt, A, Bm, Cm, D, y, h_last, L, Di, N, vec);
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
  // <state bound, lanes per channel>: 8 states a lane from N = 8 up
  if (N <= 4)
    return launch<4, 1>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 8)
    return launch<8, 1>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 16)
    return launch<16, 2>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  if (N <= 32)
    return launch<32, 4>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
  return launch<64, 8>(uf, dtf, Af, Bf, Cf, Df, yf, hf, B, L, Di, N, s);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
