// Mamba-2 selective scan (forward) for Hopper (sm_90a): a prompt's scan
// over every head and every B/C group of a Mamba-2 mixer in one launch.
//
// Replaces, on the Mamba-2 blocks' serving route, the Pallas TPU kernel
// src/repro/kernels/mamba_scan.py (mamba_scan) run as a Mamba-1 scan: the
// reference runs its plain recurrence there, and this port ran its
// Mamba-1 kernel (mamba_scan.cu) once a group over the H * P channels,
// each head's A, dt and D repeated over the head's channels and every
// state row. For batch row b, head h of group g = h / (H / G), channel p
// and state n, from h = 0:
//
//   h_t[p,n] = exp(dt_t[h] * A[h]) * h_{t-1}[p,n] + (dt_t[h] x_t[h,p]) B_t[g,n]
//   y_t[h,p] = sum_n h_t[p,n] C_t[g,n] + D[h] x_t[h,p]
//
// x, B and C are read in the activation dtype (fp32 or bf16) as the
// in-projection left them: strided views, row strides given; dt is fp32
// (B, L, H) after the softplus and is rounded to the activation dtype
// here, as the reference casts it to x's dtype before its scan. The state
// and every sum are fp32. y is written in the activation dtype, one
// rounding of the fp32 sum; the final state h_last (B, H, P, N) in fp32.
//
// What it replaced cost four things at Zamba2-7B's prefill (H 112, P 64,
// N 64, G 2, B 1): an exp for every state element and step (the Mamba-1
// kernel takes an A per channel and state: 4 096 identical ex2 per
// head-step); two calls a layer, one a group, each of 56 blocks, under
// half of the 132 SMs, one after the other; fp32 copies of x, dt
// (repeated to every channel), B and C, and a concatenation and a cast of
// y (~17 launches a layer); 1.3 % of the scan's roofline
// (counts/hybrid.scan) in all.
//
// What bounds it. The roofline counts x and y in bf16 once (~60 MB a
// layer at L 2 048): ~18 us. The recurrence is three FP32 instructions a
// state element and step (dt x times B, the decay times h plus it, h
// times C into y's sum), 0.94e9 state-steps a layer at L 2 048: ~90 us on
// the FP32 pipes of 132 SMs at ~1.75 GHz. B 1 leaves ~3 500 state chains
// an SM: a thread has to carry 32 of them, one scan warp a sub-partition,
// and the scan is bound by its instruction rate (~3.6 instructions a
// state-step) and latency, not by bytes.
//
// Design.
// * One decay a head-step: exp(dt A) is ex2.approx.ftz(dt * (A log2 e)),
//   computed once per (b, t, h) while a chunk is staged and shared by the
//   head's P x N states. It is the value the Mamba-1 kernel computed for
//   every state of the head (the same dt, A log2 e and instruction), and
//   every sum runs in that kernel's order, so y and h_last carry its bits.
// * The grid covers every group and head at once: a block owns up to 64
//   consecutive channels of one group (of one or more heads) of one batch
//   row. The host picks the block's width so that the blocks spread over
//   the SMs evenly: at B 1, 56 channels make 128 blocks on 132 SMs (64
//   would make 112).
// * Warp-specialised. The scan warps do nothing but the recurrence: a
//   channel's 64 states are split over 8 lanes of one warp, 8 states
//   each, and a thread carries 4 channels x 8 states, so each B and C
//   value read from shared memory serves 4 channels, and one decay load
//   serves them where they share a head (P % 4 == 0).
//   Eight staging warps meanwhile copy chunk k + 2 of x, B, C and dt into
//   a two-slot ring by cp.async (16 bytes a copy where the strides and
//   pointers allow, else plain loads), widen chunk k + 1 to fp32 for the
//   whole block (B and C rows, dt x, the decays) and sum chunk k - 1's y:
//   one barrier a chunk of 32 steps, none of their latency in the scan's
//   way.
// * y's sum over the lanes: the scan lanes exchange half of their
//   channels' sums by one shuffle round (xor 1), store the rest as partial
//   sums, and the staging warps add those in the order of the rounds left
//   (xor 2, 4), D x added in fp32; y goes out as coalesced rows.
// * B and C rows are swizzled in shared memory (16-byte chunk c of a
//   64-state row at c ^ ((c >> 3) & 1)), so that a quarter-warp's 16-byte
//   loads hit 8 bank groups. Ragged L and channel counts are masked.
// * One build for every N up to 64: B and C are staged as zeros past N,
//   so the padded states stay zero and add exact zeros to y's sums, whose
//   order over the lanes is the Mamba-1 kernel's at any N; their h_last
//   is not written.
//
// Measured on an H100 (B 1, L 2 048, Zamba2-7B's layer, CUDA events; the
// two Mamba-1 calls took 1.43 ms, the route with its copies 1.70): one
// launch in the Mamba-1 kernel's layout (1 channel a thread, every thread
// widening, three barriers a chunk) 0.74 ms; 2 channels a thread 0.60;
// swizzled rows, one barrier a chunk 0.45; operands loaded a step ahead
// 0.40; staging warps 0.30, with 4 channels a thread 0.256; one decay load
// 0.241; 256 staging threads, partial sums after one shuffle round and 4
// steps unrolled 0.228. B and C kept in bf16 in shared memory (half the
// loads, 16 more instructions a step) read 0.261: the instruction rate, not
// bandwidth, bounds it. The ranking held at L 4 096 and at B 32 L 512 (0.44 and
// 1.63 ms, against the Mamba-1 calls' 2.85 and 4.65).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;         // time steps staged per round
constexpr int kMaxChannels = 64;   // channels per block
constexpr int kMaxHeads = 16;      // heads a block's channels may span
constexpr int kStagers = 256;      // threads of the staging warps
constexpr int kStates = 64;        // state bound: B and C rows
constexpr int kLanes = 8;          // lanes a channel
constexpr int kSpl = kStates / kLanes;   // states a lane
constexpr int kCpt = 4;            // channels a thread
constexpr int kParts = kLanes / 2; // y's partial sums a channel
constexpr int kScanners = kMaxChannels / kCpt * kLanes;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// The staging warps' own barrier (the scan warps go on meanwhile).
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(kStagers) : "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v rounded to T and back: dt.to(dtype).float()
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
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

// One chunk as it arrives, in the activation dtype.
template <typename T>
struct Raw {
  T x[kChunk][kMaxChannels];
  T b[kChunk][kStates];
  T c[kChunk][kStates];
  float dt[kChunk][kMaxHeads];
};

// One chunk widened to fp32 for the whole block. The scan reads row t + 1
// ahead of step t: one spare row.
struct Wide {
  float b[kChunk + 1][kStates];         // B and C rows, swizzled (swz)
  float c[kChunk + 1][kStates];
  float decay[kChunk + 1][kMaxHeads];   // exp(dt A) of each head
  float du[kChunk + 1][kMaxChannels];   // dt x of each channel
  float u[kChunk][kMaxChannels];        // x
};

template <typename T>
struct Shared {
  Raw<T> raw[2];
  Wide wide[2];
  float part[2][kChunk][kParts][kMaxChannels];   // y's partial sums
  float a2[kMaxHeads];                           // A log2 e of each head
  alignas(16) float d[kMaxChannels];             // each channel's D
  int head[kMaxChannels];                        // each channel's head slot
};

// Where state n of a B or C row lies: 16-byte chunk c of a 64-state row
// at c ^ ((c >> 3) & 1), so that the 8 lanes of a quarter-warp reading
// chunks 2 g + k (8 states a lane) hit 8 different bank groups.
__device__ __forceinline__ int swz(int n) {
  return n ^ (((n >> 5) & 1) << 2);
}

struct Args {
  const void* x;
  const void* bm;
  const void* cm;
  const float* dt;
  const float* A;
  const float* D;
  void* y;
  float* h_last;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;  // batch and step strides
  int L, H, P, G, N;
  int width;   // channels a block owns
  int tiles;   // blocks a group
  int vec;     // 16-byte copies of x, B and C
};

// The block's place: batch row b, group g, channels c0 .. c0 + nc of
// heads h_lo .. h_lo + nh.
struct Tile {
  int b, g, c0, nc, h_lo, nh;
};

// Copy chunk [t0, t0 + nt) of the block's channels, its group's B and C
// rows and its heads' dt into st; zeros past L, nc, N. Staging threads
// only (s: the thread's index among them).
template <typename T>
__device__ __forceinline__ void stage_chunk(Raw<T>& st, const Args& a,
                                            const Tile& tl, int t0, int nt,
                                            int s) {
  const T* x = static_cast<const T*>(a.x) + tl.b * a.x_sb + tl.c0;
  const T* bm = static_cast<const T*>(a.bm) + tl.b * a.b_sb
                + static_cast<long long>(tl.g) * a.N;
  const T* cm = static_cast<const T*>(a.cm) + tl.b * a.c_sb
                + static_cast<long long>(tl.g) * a.N;
  if (a.vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int XV = kMaxChannels / V, NV = kStates / V;
    for (int i = s; i < kChunk * XV; i += kStagers) {
      const int t = i / XV, j = V * (i - t * XV);
      const bool ok = t < nt && j < tl.nc;
      cp_async16(&st.x[t][j], ok ? x + (t0 + t) * a.x_sl + j : x, ok);
    }
    for (int i = s; i < kChunk * NV; i += kStagers) {
      const int t = i / NV, n = V * (i - t * NV);
      const bool ok = t < nt && n < a.N;
      cp_async16(&st.b[t][n], ok ? bm + (t0 + t) * a.b_sl + n : bm, ok);
      cp_async16(&st.c[t][n], ok ? cm + (t0 + t) * a.c_sl + n : cm, ok);
    }
  } else {
    const T zero = narrow<T>(0.f);
    for (int i = s; i < kChunk * kMaxChannels; i += kStagers) {
      const int t = i / kMaxChannels, j = i - t * kMaxChannels;
      st.x[t][j] = t < nt && j < tl.nc ? x[(t0 + t) * a.x_sl + j] : zero;
    }
    for (int i = s; i < kChunk * kStates; i += kStagers) {
      const int t = i / kStates, n = i - t * kStates;
      const bool ok = t < nt && n < a.N;
      st.b[t][n] = ok ? bm[(t0 + t) * a.b_sl + n] : zero;
      st.c[t][n] = ok ? cm[(t0 + t) * a.c_sl + n] : zero;
    }
  }
  const float* dt = a.dt + (static_cast<long long>(tl.b) * a.L + t0) * a.H
                    + tl.h_lo;
  for (int i = s; i < kChunk * kMaxHeads; i += kStagers) {
    const int t = i / kMaxHeads, k = i - t * kMaxHeads;
    const bool ok = t < nt && k < tl.nh;
    cp_async4(&st.dt[t][k], ok ? dt + static_cast<long long>(t) * a.H + k
                               : a.dt, ok);
  }
}

// 16 bytes of T widened to fp32.
__device__ __forceinline__ void unpack(const uint4 r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);          // bf16 -> fp32 exactly
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// The chunk widened once for the block, 16 bytes of the raw chunk at a
// time: B and C rows, each head's decay, each channel's dt x and x (zeros
// past nc, up to the scan's channels, a multiple of 8).
template <typename T>
__device__ __forceinline__ void widen_chunk(Wide& w, const Raw<T>& st,
                                            const Shared<T>& sm,
                                            const Tile& tl, int nt,
                                            int channels, int s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RV = kStates / V;
  for (int i = s; i < nt * RV; i += kStagers) {
    const int t = i / RV, n = V * (i - t * RV);
    float fb[V], fc[V];
    unpack(*reinterpret_cast<const uint4*>(&st.b[t][n]), fb);
    unpack(*reinterpret_cast<const uint4*>(&st.c[t][n]), fc);
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const int m = swz(n + q);
      *reinterpret_cast<float4*>(&w.b[t][m]) =
          make_float4(fb[q], fb[q + 1], fb[q + 2], fb[q + 3]);
      *reinterpret_cast<float4*>(&w.c[t][m]) =
          make_float4(fc[q], fc[q + 1], fc[q + 2], fc[q + 3]);
    }
  }
  for (int i = s; i < kChunk * kMaxHeads; i += kStagers) {
    const int t = i / kMaxHeads, k = i - t * kMaxHeads;
    if (t < nt && k < tl.nh)
      w.decay[t][k] = exp2_ftz(round_to<T>(st.dt[t][k]) * sm.a2[k]);
  }
  constexpr int XV = kMaxChannels / V;
  for (int i = s; i < nt * XV; i += kStagers) {
    const int t = i / XV, j = V * (i - t * XV);
    if (j >= channels) continue;
    float u[V];
    unpack(*reinterpret_cast<const uint4*>(&st.x[t][j]), u);
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      float4 u4, du4;
      float* uq = &u4.x;
      float* dq = &du4.x;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uq[r] = j + q + r < tl.nc ? u[q + r] : 0.f;
        dq[r] = round_to<T>(st.dt[t][sm.head[j + q + r]]) * uq[r];
      }
      *reinterpret_cast<float4*>(&w.u[t][j + q]) = u4;
      *reinterpret_cast<float4*>(&w.du[t][j + q]) = du4;
    }
  }
}

// y of chunk rows [t0, t0 + nt), 4 channels a thread: each channel's
// kParts partial sums added in the order of shuffles xor 2, 4 (pairwise),
// then D x, rounded once to T and written as rows. Staging threads only.
template <typename T>
__device__ __forceinline__ void sum_y(const float (&part)[kChunk][kParts]
                                                          [kMaxChannels],
                                      const float (&u)[kChunk][kMaxChannels],
                                      const float* d, const Args& a,
                                      const Tile& tl, int t0, int nt, int s) {
  const long long Di = static_cast<long long>(a.H) * a.P;
  T* y = static_cast<T*>(a.y)
         + (static_cast<long long>(tl.b) * a.L + t0) * Di + tl.c0;
  constexpr int CV = kMaxChannels / 4;
  for (int i = s; i < nt * CV; i += kStagers) {
    const int t = i / CV, j = 4 * (i - t * CV);
    if (j >= tl.nc) continue;
    const float4 u4 = *reinterpret_cast<const float4*>(&u[t][j]);
    const float4 d4 = *reinterpret_cast<const float4*>(&d[j]);
    const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
    const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
    float4 q[kParts];
#pragma unroll
    for (int k = 0; k < kParts; ++k)
      q[k] = *reinterpret_cast<const float4*>(&part[t][k][j]);
#pragma unroll
    for (int w = 1; w < kParts; w <<= 1)
#pragma unroll
      for (int k = 0; k < kParts; k += 2 * w) {
        q[k].x += q[k + w].x;
        q[k].y += q[k + w].y;
        q[k].z += q[k + w].z;
        q[k].w += q[k + w].w;
      }
    const float ss[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
    alignas(16) T out[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = narrow<T>(ss[r] + dd[r] * uu[r]);
    T* row = y + t * Di + j;
    if (a.vec && j + 4 <= tl.nc) {
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(row) = *reinterpret_cast<const uint2*>(out);
      else
        *reinterpret_cast<uint4*>(row) = *reinterpret_cast<const uint4*>(out);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (j + r < tl.nc) row[r] = out[r];
    }
  }
}

// One round over lanes xor 1: a lane sends half of its 4 channels' sums
// and adds its partner's half to the other (odd lanes keep channels 2, 3,
// even lanes 0, 1), so v[0], v[1] hold sums over the pair.
__device__ __forceinline__ void pair_sum(float (&v)[kCpt], int lane) {
  const bool up = lane & 1;
#pragma unroll
  for (int i = 0; i < kCpt / 2; ++i) {
    const float send = up ? v[i] : v[i + kCpt / 2];
    const float keep = up ? v[i + kCpt / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
}

// Step t's operands of a thread: its channels' decays (one, shared, with
// ONE) and dt x, its lane's B and C states.
template <bool ONE>
struct Operands {
  float e[kCpt], du[kCpt], b[kSpl], c[kSpl];

  __device__ __forceinline__ void load(const float* __restrict__ wb,
                                       const float* __restrict__ wc,
                                       const float* __restrict__ wdec,
                                       const float* __restrict__ wdu,
                                       const int (&head)[kCpt],
                                       const int (&off)[kSpl / 4]) {
#pragma unroll
    for (int i = 0; i < kCpt; ++i) {
      e[i] = ONE && i > 0 ? e[0] : wdec[head[i]];
      du[i] = wdu[i];
    }
#pragma unroll
    for (int j = 0; j < kSpl; j += 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(wb + off[j / 4]);
      const float4 c4 = *reinterpret_cast<const float4*>(wc + off[j / 4]);
      b[j] = b4.x; b[j + 1] = b4.y; b[j + 2] = b4.z; b[j + 3] = b4.w;
      c[j] = c4.x; c[j + 1] = c4.y; c[j + 2] = c4.z; c[j + 3] = c4.w;
    }
  }
};

// Scan steps [0, nt) of a widened chunk: the thread's kCpt x kSpl
// states; after pair_sum, the lane's partial sums of y of 2 channels
// into part. Step t + 1's operands are loaded before step t's arithmetic.
template <bool ONE>
__device__ __forceinline__ void scan_chunk(
    float (&h)[kCpt][kSpl], const float* __restrict__ wb,
    const float* __restrict__ wc, const float* __restrict__ wdec,
    const float* __restrict__ wdu, float* __restrict__ part, int nt,
    const int (&head)[kCpt], const int (&off)[kSpl / 4], int lane) {
  Operands<ONE> cur, nxt;
  cur.load(wb, wc, wdec, wdu, head, off);
#pragma unroll 4
  for (int t = 0; t < nt; ++t) {
    nxt.load(wb + (t + 1) * kStates, wc + (t + 1) * kStates,
             wdec + (t + 1) * kMaxHeads, wdu + (t + 1) * kMaxChannels, head,
             off);
    float acc[kCpt];
#pragma unroll
    for (int i = 0; i < kCpt; ++i) {
      acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        h[i][j] = cur.e[i] * h[i][j] + cur.du[i] * cur.b[j];
        acc[i] += h[i][j] * cur.c[j];
      }
    }
    pair_sum(acc, lane);
    *reinterpret_cast<float2*>(part + t * kParts * kMaxChannels) =
        make_float2(acc[0], acc[1]);
    cur = nxt;
  }
}

// <activations and y, the thread's channels in one head>
template <typename T, bool ONE>
__global__ void __launch_bounds__(kScanners + kStagers)
mamba_scan_mamba2_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<T>& sm = *reinterpret_cast<Shared<T>*>(smem_raw);

  Tile tl;
  tl.b = blockIdx.y;
  tl.g = blockIdx.x / a.tiles;
  const int tile = blockIdx.x - tl.g * a.tiles;
  const int Cg = a.H / a.G * a.P;            // channels a group
  tl.c0 = tl.g * Cg + tile * a.width;
  tl.nc = min(a.width, Cg - tile * a.width);
  tl.h_lo = tl.c0 / a.P;
  tl.nh = (tl.c0 + tl.nc - 1) / a.P - tl.h_lo + 1;
  const int scanners = blockDim.x - kStagers;
  const int channels = scanners / kLanes * kCpt;
  const int n_chunks = (a.L + kChunk - 1) / kChunk;
  auto steps = [&](int k) { return min(kChunk, a.L - k * kChunk); };

  if (threadIdx.x >= scanners) {
    // Staging warps: chunk k + 2 copied, k + 1 widened, k - 1's y summed
    // while the scan warps run chunk k.
    const int s = threadIdx.x - scanners;
    for (int j = s; j < kMaxChannels; j += kStagers) {
      sm.head[j] = j < tl.nc ? (tl.c0 + j) / a.P - tl.h_lo : 0;
      sm.d[j] = j < tl.nc ? a.D[(tl.c0 + j) / a.P] : 0.f;
    }
    if (s < kMaxHeads)
      sm.a2[s] = s < tl.nh ? a.A[tl.h_lo + s] * kLog2e : 0.f;
    stage_chunk<T>(sm.raw[0], a, tl, 0, steps(0), s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (n_chunks > 1)
      stage_chunk<T>(sm.raw[1], a, tl, kChunk, steps(1), s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    stagers_sync();
    widen_chunk<T>(sm.wide[0], sm.raw[0], sm, tl, steps(0), channels, s);
    __syncthreads();
    for (int k = 0; k < n_chunks; ++k) {
      if (k > 0)
        sum_y<T>(sm.part[(k - 1) & 1], sm.wide[(k - 1) & 1].u, sm.d, a, tl,
                 (k - 1) * kChunk, steps(k - 1), s);
      if (k + 1 < n_chunks) {
        if (k + 2 < n_chunks)
          stage_chunk<T>(sm.raw[k & 1], a, tl, (k + 2) * kChunk,
                         steps(k + 2), s);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        stagers_sync();     // chunk k + 1 staged; chunk k - 1's y summed
        widen_chunk<T>(sm.wide[(k + 1) & 1], sm.raw[(k + 1) & 1], sm, tl,
                       steps(k + 1), channels, s);
      }
      __syncthreads();
    }
    sum_y<T>(sm.part[(n_chunks - 1) & 1], sm.wide[(n_chunks - 1) & 1].u,
             sm.d, a, tl, (n_chunks - 1) * kChunk, steps(n_chunks - 1), s);
    return;
  }

  // Scan warps.
  const int tid = threadIdx.x;
  const int grp = tid / kLanes;              // channel group in the block
  const int lane = tid - grp * kLanes;       // lane within the group
  int head[kCpt];
#pragma unroll
  for (int i = 0; i < kCpt; ++i) {
    const int j = grp * kCpt + i;
    head[i] = j < tl.nc ? (tl.c0 + j) / a.P - tl.h_lo : 0;
  }
  int off[kSpl / 4];
#pragma unroll
  for (int j = 0; j < kSpl; j += 4) off[j / 4] = swz(lane * kSpl + j);
  // the lane's partial sums: the (lane >> 1)-th of kParts of channels
  // cw, cw + 1 (pair_sum: odd lanes keep the thread's channels 2, 3)
  const int cw = grp * kCpt + (lane & 1 ? kCpt / 2 : 0);
  const int pslot = (lane >> 1) * kMaxChannels + cw;

  float h[kCpt][kSpl];
#pragma unroll
  for (int i = 0; i < kCpt; ++i)
#pragma unroll
    for (int j = 0; j < kSpl; ++j) h[i][j] = 0.f;

  __syncthreads();          // chunk 0 widened
  for (int k = 0; k < n_chunks; ++k) {
    const Wide& w = sm.wide[k & 1];
    scan_chunk<ONE>(h, &w.b[0][0], &w.c[0][0], &w.decay[0][0],
                    &w.du[0][grp * kCpt], &sm.part[k & 1][0][0][0] + pslot,
                    steps(k), head, off, lane);
    __syncthreads();        // chunk k scanned; k + 1 widened
  }
  // h_last (B, H, P, N): channel c0 + j of batch row b at ((b H P) + c) N
#pragma unroll
  for (int i = 0; i < kCpt; ++i) {
    const int j = grp * kCpt + i;
    if (j >= tl.nc) continue;
    float* hl = a.h_last
                + (static_cast<long long>(tl.b) * a.H * a.P + tl.c0 + j) * a.N;
#pragma unroll
    for (int s = 0; s < kSpl; ++s)
      if (lane * kSpl + s < a.N) hl[lane * kSpl + s] = h[i][s];
  }
}

// The block's width in channels (a multiple of 8 up to kMaxChannels, at
// most 15 P + 1 so that it spans at most kMaxHeads heads wherever it
// starts): the one that puts the least work on the busiest SM,
// ceil(blocks / SMs) x (width + 16: a block's staging of B and C), the
// widest among equals.
int plan_width(int B, int G, int Cg, int P, int sms) {
  int best = 8;
  long long best_load = -1;
  for (int w = kMaxChannels; w >= 8; w -= 8) {
    if ((w - 1) / P + 2 > kMaxHeads && w > 8) continue;
    const long long blocks =
        static_cast<long long>(B) * G * ((Cg + w - 1) / w);
    const long long load = (blocks + sms - 1) / sms
                           * ((w < Cg ? w : Cg) + 16);
    if (best_load < 0 || load < best_load) {
      best = w;
      best_load = load;
    }
  }
  return best;
}

template <typename T, bool ONE>
int launch(Args a, int B, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cg = a.H / a.G * a.P;
  a.width = plan_width(B, a.G, Cg, a.P, sms);
  a.tiles = (Cg + a.width - 1) / a.width;
  const size_t smem = sizeof(Shared<T>);
  auto kernel = mamba_scan_mamba2_kernel<T, ONE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies: x, B and C rows start on 16 bytes at every block
  constexpr int V = 16 / sizeof(T);
  const auto bits = reinterpret_cast<unsigned long long>(a.x)
                    | reinterpret_cast<unsigned long long>(a.bm)
                    | reinterpret_cast<unsigned long long>(a.cm);
  a.vec = (bits & 15ull) == 0 && Cg % 8 == 0 && a.N % V == 0
          && (a.x_sb | a.x_sl | a.b_sb | a.b_sl | a.c_sb | a.c_sl) % V == 0;
  const int groups = (a.width + kCpt - 1) / kCpt;
  const int threads = (groups * kLanes + 31) / 32 * 32 + kStagers;
  const dim3 grid(a.G * a.tiles, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// one decay load for a thread's 4 channels where they share a head
template <typename T>
int dispatch(const Args& a, int B, cudaStream_t s) {
  if (a.P % 4 == 0) return launch<T, true>(a, B, s);
  return launch<T, false>(a, B, s);
}

}  // namespace

extern "C" {

// x (B, L, H, P) with strides (x_sb, x_sl, P, 1); Bm, Cm (B, L, G, N)
// with strides (sb, sl, N, 1), in the activation dtype (bf16: bf16, else
// fp32); dt (B, L, H), A and D (H,) fp32 and contiguous; outputs y
// (B, L, H, P) contiguous in the activation dtype, and h_last
// (B, H, P, N) fp32 contiguous. H % G == 0, N <= 64. Launches on
// `stream` and returns cudaGetLastError().
int mamba2_scan_fwd(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* h_last, long long x_sb, long long x_sl,
                    long long b_sb, long long b_sl, long long c_sb,
                    long long c_sl, int B, int L, int H, int P, int G, int N,
                    int bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0
      || N > kStates || H % G || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.x = x;
  a.bm = Bm;
  a.cm = Cm;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.h_last = static_cast<float*>(h_last);
  a.x_sb = x_sb;
  a.x_sl = x_sl;
  a.b_sb = b_sb;
  a.b_sl = b_sl;
  a.c_sb = c_sb;
  a.c_sl = c_sl;
  a.L = L;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(a, B, s);
  return dispatch<float>(a, B, s);
}

const char* mamba2_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
