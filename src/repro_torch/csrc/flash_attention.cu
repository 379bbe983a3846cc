// Causal / sliding-window GQA flash attention (forward) for Hopper
// (sm_90a), fp32 or bf16 in, fp32 arithmetic, output in the input dtype:
// the SIMT route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pl.pallas_call at :116, body _kernel at :33) for what
// the tensor-core kernel (flash_attention_sm90.cu, the wgmma route) does
// not take: fp32 inputs, bf16 head dims that are not a multiple of 16,
// and tensors that do not start on a 16-byte boundary. The route is chosen
// in Python (repro_torch/kernels/flash_attention.py::route). For every
// batch b, query head h and query row i it computes
//
//   out[b,i,h] = sum_j p_ij v[b,j,h/G] / max(sum_j p_ij, 1e-30)
//   p_ij = exp(s_ij - m_i) on live keys, 0 on masked ones,
//   s_ij = q[b,i,h] . k[b,j,h/G] / sqrt(hd),  m_i = max over live s_ij
//
// by the online softmax: per key tile the running max m, denominator l and
// accumulator are rescaled by exp(m_old - m_new). G = Hq / Hkv (GQA: the kv
// head is read in place, never repeated). Queries are right-aligned: row i
// sits at position i + Sk - Sq. Key j is live when j < Sk, and j <= pos(i)
// if causal, and j > pos(i) - window if a window is set. Masked scores take
// the reference's NEG_INF = -2^30 (not -inf), masked p is zeroed and l is
// clamped at 1e-30, so a row with no live key gives 0, not NaN — the
// reference kernel's arithmetic, which the plain version
// (repro_torch/kernels/ref.py::flash_attention_ref) repeats.
//
// Layout: q, out (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), contiguous —
// the model's layout, read in place (no transposes, no padding). Ragged
// Sq, Sk and hd are masked inside the kernel.
//
// Design. One block of 128 threads per (batch x query head, 64-row query
// tile); heavy causal tiles are scheduled first. The query tile and each 64-key
// K/V tile are staged in shared memory as fp32, row-major, through
// 16-byte global loads, several in flight per thread (a scalar path
// serves head dims that are not a multiple of 16 bytes, or unaligned
// tensors). A thread owns 4 query rows x 8 keys of the score tile and
// 4 rows x hd/8 output columns, all in registers; a row's 8 lanes reduce
// its max and sum with warp shuffles. Q, K, P and V are read from shared
// memory as float4, one load per 10-13 FMAs, on bank-conflict-free
// strides. P goes through shared memory (aliasing the K tile) for the P.V
// product. Key tiles wholly outside the causal frontier or the window are
// skipped. Both products run on the fp32 FMA pipes, not the tensor
// cores: the reference's flash route multiplies in fp32 (q, k, v upcast,
// p never rounded), and tf32/bf16 tensor-core products would change its
// numbers.
//
// What bounds it. The fp32 FMA pipes (67 TFLOP/s peak). At the bf16
// serving shape (B=4, S=2048, Hq=32, Hkv=8, hd=128, causal) the
// work is 137 GFLOP against 168 MB of traffic, 0.14 ms on the tensor
// cores: this kernel cannot come within 15x of that, which is why bf16
// takes the wgmma route. Its shapes here are the fp32 checks and the odd
// bf16 head dims, off the serving path; PERF.md has its time at the
// serving shape beside the wgmma route's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kThreads = 128;              // 16 row groups x 8 lanes
constexpr int kPS = kBQ + 4;               // row stride of P (key-major)
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);              // round to nearest even
}

// 16 bytes of T widened to fp32 and stored at dst (16-byte aligned).
__device__ __forceinline__ void store_wide(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void store_wide(float* dst, uint4 raw,
                                           __nv_bfloat16) {
  // a bf16 is the high half of the fp32 with the same value
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
      __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
}

// Shared-memory layout, in floats. Q, K and V rows have HD + 4 floats:
// 16-byte aligned, and an odd number of 16-byte units, so the 8 lanes of
// a row group reading 8 different K rows hit 8 different banks.
template <int HD>
struct Layout {
  static constexpr int kRow = HD + 4;
  static constexpr int kQ = kBQ * kRow;
  static constexpr int kKP = kBK * kRow > kBK * kPS ? kBK * kRow : kBK * kPS;
  static constexpr int kV = kBK * kRow;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
};

// Stage rows [row0, row0 + 64) of kMats (rows, hd) matrices of T (row
// stride `stride` elements) into fp32 shared tiles [64][HD + 4]: zeros
// past `rows` and past hd. `vec`: hd is a multiple of 16 bytes of T and
// the pointers are 16-byte aligned, so each thread moves whole 16-byte
// vectors, kGroup of them per matrix in flight at once.
template <typename T, int HD, int kMats>
__device__ __forceinline__ void stage(float* const (&dst)[2],
                                      const T* const (&src)[2],
                                      long long stride, int row0, int rows,
                                      int hd, bool vec) {
  constexpr int ld = Layout<HD>::kRow;
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    constexpr int kPerRow = HD / kVec;
    constexpr int kIters = 64 * kPerRow / kThreads;
    constexpr int kGroup = kIters < 4 ? kIters : 4;
#pragma unroll
    for (int g = 0; g < kIters; g += kGroup) {
      uint4 raw[kMats][kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int idx = threadIdx.x + (g + u) * kThreads;
        const int r = idx / kPerRow;
        const int d = (idx - r * kPerRow) * kVec;
        const bool live = r < rows && d < hd;
#pragma unroll
        for (int m = 0; m < kMats; ++m) {
          raw[m][u] = live ? *reinterpret_cast<const uint4*>(
                                 src[m] + (row0 + r) * stride + d)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int idx = threadIdx.x + (g + u) * kThreads;
        const int r = idx / kPerRow;
        const int d = (idx - r * kPerRow) * kVec;
#pragma unroll
        for (int m = 0; m < kMats; ++m)
          store_wide(dst[m] + r * ld + d, raw[m][u], T());
      }
    }
  } else {
#pragma unroll 8
    for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const bool live = r < rows && d < hd;
#pragma unroll
      for (int m = 0; m < kMats; ++m)
        dst[m][r * ld + d] =
            live ? to_f32(src[m][(row0 + r) * stride + d]) : 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                       int window, float scale, int vec) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 8;            // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // [kBQ][HD+4]
  float* Ks = Qs + L::kQ;                  // [kBK][HD+4]
  float* Ps = Ks;                          // [kBK][kBQ+4], aliases Ks
  float* Vs = Ks + L::kKP;                 // [kBK][HD+4]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;                 // row group: rows ty*4 .. +3
  const int tx = tid & 7;                  // lane in the row group
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int off = Sk - Sq;                 // right-aligned queries

  const long long q_row_stride = static_cast<long long>(Hq) * hd;
  const long long k_row_stride = static_cast<long long>(Hkv) * hd;
  const T* qb = q + (static_cast<long long>(b) * Sq) * q_row_stride
                + static_cast<long long>(h) * hd;
  const T* kb = k + (static_cast<long long>(b) * Sk) * k_row_stride
                + static_cast<long long>(hk) * hd;
  const T* vb = v + (static_cast<long long>(b) * Sk) * k_row_stride
                + static_cast<long long>(hk) * hd;

  {
    float* const dst[2] = {Qs, nullptr};
    const T* const src[2] = {qb, nullptr};
    stage<T, HD, 1>(dst, src, q_row_stride, q0, Sq - q0, hd, vec != 0);
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // the keys any row of this tile can see
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, pos_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int nd4 = (hd + 3) / 4;            // float4 steps over the head dim

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    {
      float* const dst[2] = {Ks, Vs};
      const T* const src[2] = {kb, vb};
      stage<T, HD, 2>(dst, src, k_row_stride, k0, Sk - k0, hd, vec != 0);
    }
    __syncthreads();  // Q (first tile), K and V staged

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d4 = 0; d4 < nd4; ++d4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (ty * 4 + i) * L::kRow + 4 * d4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 8 * j) * L::kRow + 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int pos = q0 + row + off;
      bool live[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx + 8 * j;
        live[j] = q0 + row < Sq && key < Sk && (!causal || key <= pos)
                  && (window <= 0 || key > pos - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;  // s now holds p
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every score read of Ks done: Ps may overwrite it
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 8 * j) * kPS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // P staged

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha[i];
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + c * kPS
                                                         + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        // this thread's output columns 32 g + 4 tx .. + 3
        const float4 v4 = *reinterpret_cast<const float4*>(
            Vs + c * L::kRow + 32 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], v4.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], v4.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], v4.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], v4.w, acc[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();  // P and V consumed before the next tile lands
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = out + (static_cast<long long>(b) * Sq + r) * q_row_stride
              + static_cast<long long>(h) * hd;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = 32 * (j / 4) + 4 * tx + (j % 4);
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte staging: whole vectors per row, from 16-byte aligned tensors
  const auto bits = reinterpret_cast<unsigned long long>(q)
                    | reinterpret_cast<unsigned long long>(k)
                    | reinterpret_cast<unsigned long long>(v);
  const int vec = hd % (16 / static_cast<int>(sizeof(T))) == 0
                  && (bits & 15ull) == 0;
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, hd,
      causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
              int window, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal,
                         window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal,
                         window, scale, stream);
  return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal,
                        window, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. scale is
// the score scale (1/sqrt(hd)). Launches on `stream` and returns
// cudaGetLastError(): a launch the runtime refuses never runs, and a later
// synchronize would not say so.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int dtype, int B, int Sq, int Sk, int Hq,
                        int Hkv, int hd, int causal, int window, float scale,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0
      || hd <= 0 || hd > 128 || (Sq + kBQ - 1) / kBQ > 65535
      || static_cast<long long>(B) * Hq > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal,
                            window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd,
                                    causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
