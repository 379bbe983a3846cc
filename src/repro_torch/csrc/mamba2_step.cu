// Mamba-2 decode state step (forward) for Hopper (sm_90a), K5: one token of
// a Mamba-2 mixer for every sequence, head and B/C group, the layer's conv
// and SSM state updated in place.
//
// Replaces no TPU kernel: the reference's decode recurrence is plain
// arithmetic (src/repro/models/ssm.py, causal_conv1d and mamba2_scan over
// one step), as the port ran it until this kernel. For batch row b,
// conv channel c (the x of every head, then B and C of every group), head
// h of group g = h / (H / G), channel p and state n:
//
//   a[c]      = silu(round(sum_k w[c,k] win[k,c] + bias[c]))   win: the
//               K - 1 cached inputs and this one; the cache shifts by one
//   dt[h]     = round(softplus(dt_raw[h] + dt_bias[h]))
//   h[p,n]    = exp(dt[h] * -exp(A_log[h])) h[p,n] + (dt[h] x[h,p]) B[g,n]
//   y[h,p]    = round(round(sum_n h[p,n] C[g,n]) + D[h] x[h,p])
//
// where round() is the activation dtype's (fp32 or bf16) and every sum and
// product is fp32. These are the plain step's numerics
// (kernels/mamba2_step.py, plain) but for the conv window: the plain
// step in bf16 rounds each tap's product and partial sum to bf16, this
// kernel sums the taps in fp32 and rounds once. The state update's two
// products and its sum are rounded one by one (__fmul_rn, __fadd_rn, no
// contraction into an FMA), as the plain step's three tensor ops round
// them, so in fp32 the state carries its bits given the same inputs.
//
// What bounds it. At Zamba2-7B's decode (B 32, H 112, P 64, N 64, G 2,
// K 4) a layer's fp32 SSM state is 58.7 MB, read and written once: 117.4
// MB, 35.0 us at 3.35 TB/s. Everything else is ~4 MB: the conv state
// (bf16, 3 taps of 7 424 channels), the projection's columns read, the
// activations and y. The plain step made ~9 passes over the 58.7 MB (the
// state twice expanded, dBu, dA h, their sum, the einsum's read, the copy
// back into the cache) and ~40 launches a layer.
//
// Design. Two launches a layer, on the caller's stream, allocating
// nothing (the wrapper passes a (B, C) scratch for the activations):
// * mamba2_conv_step_kernel: a thread a (row, conv channel): the window,
//   SiLU, and the conv state's shift in place. It runs first because B
//   and C's conv state is shared by the H / G heads of a group: a state
//   block that shifted it in place could race another still reading it.
// * mamba2_state_step_kernel: a block of 128 threads a (row, head, 32
//   channels), 7 168 blocks at B 32. A row's N states lie on 16 lanes, 4
//   consecutive states a lane (one 128-bit load and store), so a warp
//   streams two 256-byte rows; a thread holds 4 rows, every load issued
//   before the first use. Each block computes its head's dt and decay
//   itself (a few SFU results, not worth a launch). y's sum over a row
//   closes by 4 xor-shuffles within the 16 lanes. The state is read and
//   written with streaming hints (ld/st .cs): no one reads it again
//   before the next step, 81 layers later. N not a multiple of 4, or a
//   state not 16-byte aligned, takes the scalar form: 32 lanes a row, 2
//   states a lane.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConvThreads = 256;   // conv kernel: a thread a channel
constexpr int kMaxConv = 8;         // taps K
constexpr int kStates = 64;         // state bound N
constexpr int kThreads = 128;       // state kernel's block
constexpr int kPasses = 4;          // rows a thread holds

template <typename T>
__device__ __forceinline__ float widen(T v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(v);
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// v rounded to T and back: t.to(dtype).float()
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return widen<T>(narrow<T>(v));
}

// torch's softplus at beta 1, threshold 20
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// The conv window of channel c of row b: K taps over the K - 1 cached
// inputs (read in the cache dtype S, used in the activation dtype T, as
// the plain step's state.to(dtype)) and this token's; fp32 sums, bias,
// one rounding, SiLU, one rounding. The cache then shifts by one, this
// token's input last.
template <typename T, typename S>
__global__ void __launch_bounds__(kConvThreads)
mamba2_conv_step_kernel(const T* __restrict__ xbc, long long x_sb,
                        const T* __restrict__ w, const T* __restrict__ bias,
                        S* __restrict__ state, T* __restrict__ act, int C,
                        int K) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  S* st = state + static_cast<long long>(b) * (K - 1) * C + c;
  const T* wc = w + static_cast<long long>(c) * K;
  const float xn = widen<T>(xbc[b * x_sb + c]);
  float win[kMaxConv - 1];
#pragma unroll
  for (int k = 0; k < kMaxConv - 1; ++k)
    win[k] = k < K - 1
        ? round_to<T>(widen<S>(st[static_cast<long long>(k) * C])) : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxConv - 1; ++k)
    if (k < K - 1) acc = __fadd_rn(acc, __fmul_rn(win[k], widen<T>(wc[k])));
  acc = __fadd_rn(acc, __fmul_rn(xn, widen<T>(wc[K - 1])));
  const float v = round_to<T>(__fadd_rn(acc, widen<T>(bias[c])));
  act[static_cast<long long>(b) * C + c] = narrow<T>(v / (1.f + expf(-v)));
#pragma unroll
  for (int k = 0; k < kMaxConv - 2; ++k)
    if (k < K - 2) st[static_cast<long long>(k) * C] = narrow<S>(win[k + 1]);
  if (K > 1) st[static_cast<long long>(K - 2) * C] = narrow<S>(xn);
}

// VEC states a lane, read and written at once; LANES lanes a row, VECS
// vectors a lane: every N up to kStates.
template <int VEC>
struct Layout;
template <>
struct Layout<4> {
  static constexpr int kLanes = 16, kVecs = 1;
};
template <>
struct Layout<1> {
  static constexpr int kLanes = 32, kVecs = 2;
};

template <int VEC>
__device__ __forceinline__ void load_cs(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_cs(float* p, const float* v) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

// The state step of rows blockIdx.y * rows .. + rows of head h of batch
// row b (blockIdx.x = b H + h), from the conv kernel's activations.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mamba2_state_step_kernel(const T* __restrict__ act,
                         const T* __restrict__ dt_raw, long long dt_sb,
                         const float* __restrict__ dt_bias,
                         const float* __restrict__ A_log,
                         const float* __restrict__ D, float* __restrict__ h,
                         T* __restrict__ y, int H, int P, int G, int N) {
  constexpr int kLanes = Layout<VEC>::kLanes;
  constexpr int kVecs = Layout<VEC>::kVecs;
  constexpr int kCols = kVecs * VEC;          // states a thread holds a row
  constexpr int kRows = kThreads / kLanes;    // rows a pass
  const int bh = blockIdx.x;
  const int b = bh / H, hd = bh - b * H;
  const int g = hd / (H / G);
  const int lane = threadIdx.x % kLanes;
  const T* row = act + static_cast<long long>(b) * (H * P + 2 * G * N);
  const T* u = row + hd * P;
  const T* bg = row + H * P + g * N;
  const T* cg = bg + G * N;

  const float dt = round_to<T>(softplus(
      __fadd_rn(widen<T>(dt_raw[b * dt_sb + hd]), dt_bias[hd])));
  const float dA = expf(__fmul_rn(dt, -expf(A_log[hd])));
  const float d = D[hd];
  int col[kVecs];
  float bv[kCols], cv[kCols];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    col[k] = (k * kLanes + lane) * VEC;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int n = col[k] + v;
      bv[k * VEC + v] = n < N ? widen<T>(bg[n]) : 0.f;
      cv[k * VEC + v] = n < N ? widen<T>(cg[n]) : 0.f;
    }
  }

  const int p0 = blockIdx.y * kRows * kPasses + threadIdx.x / kLanes;
  float* hb = h + static_cast<long long>(bh) * P * N;
  float s[kPasses][kCols];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int p = p0 + i * kRows;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (p < P && col[k] < N) {
        load_cs<VEC>(hb + static_cast<long long>(p) * N + col[k],
                     &s[i][k * VEC]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) s[i][k * VEC + v] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int p = p0 + i * kRows;
    const bool live = p < P;
    const float x = live ? widen<T>(u[p]) : 0.f;
    const float du = __fmul_rn(dt, x);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[i][j] = __fadd_rn(__fmul_rn(dA, s[i][j]), __fmul_rn(du, bv[j]));
      part = fmaf(s[i][j], cv[j], part);
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (live && col[k] < N)
        store_cs<VEC>(hb + static_cast<long long>(p) * N + col[k],
                      &s[i][k * VEC]);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (live && lane == 0)
      y[static_cast<long long>(bh) * P + p] =
          narrow<T>(__fadd_rn(round_to<T>(part), __fmul_rn(x, d)));
  }
}

template <typename T, typename S>
int launch_conv(const void* xbc, long long x_sb, const void* w,
                const void* bias, void* state, void* act, int B, int C,
                int K, cudaStream_t s) {
  const dim3 grid((C + kConvThreads - 1) / kConvThreads, B);
  mamba2_conv_step_kernel<T, S><<<grid, kConvThreads, 0, s>>>(
      static_cast<const T*>(xbc), x_sb, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<S*>(state),
      static_cast<T*>(act), C, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_state(const void* act, const void* dt_raw, long long dt_sb,
                 const float* dt_bias, const float* A_log, const float* D,
                 float* h, void* y, int B, int H, int P, int G, int N,
                 cudaStream_t s) {
  constexpr int rows = kThreads / Layout<VEC>::kLanes * kPasses;
  const dim3 grid(B * H, (P + rows - 1) / rows);
  mamba2_state_step_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(act), static_cast<const T*>(dt_raw), dt_sb,
      dt_bias, A_log, D, h, static_cast<T*>(y), H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The conv window of one token: xbc (B, 1, C) in the activation dtype
// (bf16: bf16, else fp32) with row stride x_sb and unit column stride;
// w (C, K) and bias (C,) in that dtype, contiguous; state (B, K - 1, C)
// contiguous in its own dtype (state_bf16), shifted in place; act (B, C)
// contiguous in the activation dtype, written. 1 <= K <= 8. Launches on
// `stream` and returns cudaGetLastError().
int mamba2_conv_step_fwd(const void* xbc, long long x_sb, const void* w,
                         const void* bias, void* state, void* act, int B,
                         int C, int K, int bf16, int state_bf16,
                         void* stream) {
  if (B <= 0 || C <= 0 || K < 1 || K > kMaxConv || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && state_bf16)
    return launch_conv<__nv_bfloat16, __nv_bfloat16>(xbc, x_sb, w, bias,
                                                     state, act, B, C, K, s);
  if (bf16)
    return launch_conv<__nv_bfloat16, float>(xbc, x_sb, w, bias, state, act,
                                             B, C, K, s);
  if (state_bf16)
    return launch_conv<float, __nv_bfloat16>(xbc, x_sb, w, bias, state, act,
                                             B, C, K, s);
  return launch_conv<float, float>(xbc, x_sb, w, bias, state, act, B, C, K,
                                   s);
}

// The state step: act (B, H P + 2 G N) from mamba2_conv_step_fwd (x of
// every head, then B and C of every group); dt_raw (B, 1, H) in the
// activation dtype with row stride dt_sb and unit column stride; dt_bias,
// A_log and D (H,) fp32; h (B, H, P, N) fp32 contiguous, updated in
// place; y (B, 1, H P) contiguous in the activation dtype. H % G == 0,
// N <= 64. Launches on `stream` and returns cudaGetLastError().
int mamba2_state_step_fwd(const void* act, const void* dt_raw,
                          long long dt_sb, const void* dt_bias,
                          const void* A_log, const void* D, void* h, void* y,
                          int B, int H, int P, int G, int N, int bf16,
                          void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || N > kStates
      || H % G || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* a = static_cast<const float*>(A_log);
  const float* dd = static_cast<const float*>(D);
  float* hh = static_cast<float*>(h);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  if (bf16 && vec)
    return launch_state<__nv_bfloat16, 4>(act, dt_raw, dt_sb, bias, a, dd,
                                          hh, y, B, H, P, G, N, s);
  if (bf16)
    return launch_state<__nv_bfloat16, 1>(act, dt_raw, dt_sb, bias, a, dd,
                                          hh, y, B, H, P, G, N, s);
  if (vec)
    return launch_state<float, 4>(act, dt_raw, dt_sb, bias, a, dd, hh, y, B,
                                  H, P, G, N, s);
  return launch_state<float, 1>(act, dt_raw, dt_sb, bias, a, dd, hh, y, B, H,
                                P, G, N, s);
}

const char* mamba2_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
