// Single-token GQA decode attention over a layer's KV cache for Hopper
// (sm_90a), bf16 in, fp32 sums, bf16 out: K4.
//
// Replaces no TPU kernel: the reference's decode attention is plain
// einsums (src/repro/models/attention.py, _sdpa over the cache). It was
// added because the port's plain decode attention (attention_decode ->
// _gqa) cast the whole (B, Hkv, S_max, hd) bf16 cache to fp32 on every
// layer of every step, ran two fp32 products over all S_max slots and
// masked about half of them away afterwards: ~29 of Mistral-NeMo-12B's
// 43 device ms a step at B 32, 56 of Zamba2-7B's 96. For every batch b
// and query head h = kvh * G + g it computes
//
//   out[b,h] = sum_j bf(p_j) v[b,kvh,j],  p_j = e_j / sum_j' e_j',
//   e_j = exp(s_j - max_j' s_j'),  s_j = (q[b,h] . k[b,kvh,j]) * scale
//
// over the live slots j of the decode mask (live_range below, the same
// arithmetic as repro_torch/kernels/decode_attention.py::live_range):
// [max(0, pos - window + 1), pos] with a window, [0, pos] without one,
// and on a ring (S_max <= window) every slot once pos >= S_max. bf()
// rounds the normalised probability to bf16, as the plain path does
// (kernels/ref.py::gqa_ref): the products of the cache's values are exact
// in fp32, the sums are fp32, and the output is rounded once. bf16 is the
// served dtype; an fp32 model's decode takes the plain path
// (models/attention.py::uses_decode_kernel). pos is a host integer or,
// for a CUDA graph that replays the step, an int64 read on the card: the
// grid depends on shapes alone, and only live slots are read.
//
// What bounds it. Bytes: each live K and V row is read once, at ~G
// multiply-adds a byte (G = Hq / Hkv, 1 to 8), far under the card's ~295
// operations a byte. Mistral-NeMo's decode (B 32, 8 KV heads of 128,
// 1280 live slots) reads 168 MB a layer, 50 us at 3.35 TB/s; Zamba2-7B's
// (32 KV heads of 224) 1.17 GB an application, 0.35 ms.
//
// Design.
// * A block serves one (batch, KV head) and all its G query heads (at
//   most 8, the families' largest G), so GQA reads a KV head once.
// * The softmax is normalised before p is rounded, so the row's max and
//   denominator must be known before p.V. The live positions are split
//   over a thread-block cluster of `splits` blocks (decode_attention_plan
//   below, from the shapes and the card: the fewest slices whose scores
//   fit in a block's shared memory, then the most that still run every
//   cluster at once, by the runtime's own occupancy count): each block
//   keeps its slice's fp32 scores, and the blocks exchange their (max,
//   sum of exps) and then their partial outputs through distributed
//   shared memory, summing the slices in rank order. No atomics: two
//   calls give the same bits, and the int and device-pos routes the same
//   bits. Each block's slice is an equal share of the live range read on
//   the card; a block whose share is empty reads nothing and adds zeros.
// * The scores stay in shared memory up to kMaxSplits slices of them; a
//   longer cache (from ~97k slots at G 4, ~48k at G 8) keeps them in a
//   scratch of fp32 in device memory instead, a block's own rows, which
//   L2 holds (16.8 MB at B 1, G 4 over 131072 slots). Nothing else
//   changes: the same arithmetic in the same order.
// * K and V stream through a ring of kStages tiles in shared memory,
//   filled by 16-byte cp.async copies kStages - 1 tiles ahead: the
//   slice's K tiles, then its V tiles, so the first V tiles load while
//   the cluster exchanges the softmax's max and sum. A tile's rows are
//   padded by 16 bytes, so that ldmatrix's eight rows fall in eight bank
//   groups.
// * Both products on the tensor cores, mma.sync m16n8k16 with fp32
//   accumulators (bf16 products are exact in fp32).
//   q.K^T: K rows are A (16 rows a warp step, ldmatrix), the block's
//   query heads are B's 8 columns (from registers). p.V: p (the block's
//   heads, padded to 16 rows) is A, V's rows are B (ldmatrix.trans); each
//   warp owns 16-column slices of the output. A first version did both
//   products on the fp32 pipes, a lane per 8 elements of a row, and took
//   3.2x the bytes' bound at Mistral-NeMo's shape (this design 1.45x):
//   its shuffles and per-head guards cost more instructions than the
//   bytes allow. The one template parameter, kKSteps, is the number of
//   16-wide k-steps of q.K^T (the next power of two of hd / 16).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 8;       // query heads a block: G (MAX_GROUP)
constexpr int kMaxSplits = 8;      // blocks of a cluster (portable size)
constexpr int kStageBytes = 9216;  // one tile of K or V rows
constexpr int kStages = 4;         // tiles in the ring, kStages - 1 in flight
constexpr int kPad = 16;           // bytes after each row of a tile
constexpr unsigned kFull = 0xffffffffu;

// x rounded to bf16 (round to nearest even) and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes from global to shared memory; zeros where `bytes` is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; .trans delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a b: a 16x16 (row), b 16x8 (col) bf16, c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The decode mask's live slots [lo, hi) at pos; window <= 0: none.
__device__ __forceinline__ void live_range(long long pos, int S_max,
                                           int window, int& lo, int& hi) {
  long long h = pos + 1 < S_max ? pos + 1 : S_max;
  if (h < 0) h = 0;
  long long l = 0;
  if (window > 0 && S_max > window) {       // not a ring: the window
    l = pos - window + 1;
    if (l < 0) l = 0;
    if (l > h) l = h;
  }
  lo = static_cast<int>(l);
  hi = static_cast<int>(h);
}

// A tile's row stride in bytes and rows: as many padded rows as
// kStageBytes holds, a multiple of 16 for the tensor cores' 16-row steps.
__device__ __forceinline__ int tile_ld(int hd) {
  return hd * 2 + kPad;
}
__device__ __forceinline__ int tile_rows(int hd) {
  return kStageBytes / tile_ld(hd) / 16 * 16;
}

// Shared memory: the ring of K and V tiles (kStages x kStageBytes); then,
// in floats, the slice's scores [G][cap] unless they are in the scratch
// (`spill`), the block's partial output [G][hd] (which the cluster
// reads), its max and sum of exps [2][kMaxHeads].
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int cap, int hd,
                                                      bool spill) {
  return static_cast<size_t>(kStages) * kStageBytes
         + sizeof(float) * ((spill ? 0 : static_cast<size_t>(G) * cap)
                            + G * hd + 2 * kMaxHeads);
}

__host__ __device__ __forceinline__ int slice_cap(int S_max, int splits) {
  return (S_max + splits - 1) / splits;
}

template <int kKSteps>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        const long long* __restrict__ pos_dev,
                        long long pos_host, int Hkv, int G, int S_max,
                        int hd, int window, float scale, int cap,
                        float* scratch) {
  constexpr int kPairs = (kKSteps + kWarps - 1) / kWarps;  // per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int bk = blockIdx.x / splits;             // b * Hkv + kvh
  const int heads = G;
  const long long q_row = static_cast<long long>(bk) * G;  // first head

  unsigned char* ring = smem_raw;
  float* f_s = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  float* sc = scratch != nullptr                  // [G][cap]
      ? scratch + static_cast<size_t>(blockIdx.x) * G * cap : f_s;
  float* o_s = scratch != nullptr ? f_s : f_s + G * cap;   // [G][hd]
  float* st = o_s + G * hd;                       // max [8], sum [8]

  const long long pos = pos_dev != nullptr ? *pos_dev : pos_host;
  int lo, hi;
  live_range(pos, S_max, window, lo, hi);
  const int n = hi - lo;
  const int share = (n + splits - 1) / splits;
  const int j0 = lo + min(rank * share, n);
  const int rows = min((rank + 1) * share, n) - min(rank * share, n);
  const int ld = tile_ld(hd);
  const int tile = tile_rows(hd);
  const int tiles = (rows + tile - 1) / tile;
  const int row_chunks = hd * 2 / 16;
  const size_t slice = (static_cast<size_t>(bk) * S_max + j0) * hd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // tile t of the slice's K tiles, then of its V tiles, into the ring
  // (rows past the slice, up to the tensor cores' next 16, as zeros); one
  // commit group a call, empty past the last tile
  auto issue = [&](int t) {
    if (t < 2 * tiles) {
      const int r0 = (t < tiles ? t : t - tiles) * tile;
      const int nr = min(tile, rows - r0);
      const int fill = (nr + 15) / 16 * 16;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (t < tiles ? k : v) + slice + static_cast<size_t>(r0) * hd);
      unsigned char* dst = ring + (t % kStages) * kStageBytes;
      for (int i = threadIdx.x; i < fill * row_chunks; i += kThreads) {
        const int r = i / row_chunks, cc = i - r * row_chunks;
        cp_async16(dst + r * ld + cc * 16,
                   src + (r < nr ? i * 16 : 0), r < nr ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // q: the B fragments of q.K^T (column g = query head g, two k values a
  // register)
  uint32_t qb[kKSteps][2];
  {
    const int g = lane / 4;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int d = ks * 16 + (lane % 4) * 2;
      const bool on = g < heads && d < hd;
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          q + (q_row + (on ? g : 0)) * hd + (on ? d : 0));
      qb[ks][0] = on ? qp[0] : 0u;
      qb[ks][1] = on ? qp[4] : 0u;                // d + 8
    }
  }

  // 1. scores of the slice's rows, a tile at a time
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(t + kStages - 1);
    const unsigned char* tl = ring + (t % kStages) * kStageBytes;
    const int r0 = t * tile, nr = min(tile, rows - r0);
    // a warp's 16 rows at a time: c[0..1] rows lane / 4, heads
    // 2 (lane % 4) + {0, 1}; c[2..3] the rows 8 further
    for (int m0 = warp * 16; m0 < nr; m0 += kWarps * 16) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned a0 = smem_addr(tl + (m0 + lane % 16) * ld
                                    + (lane / 16) * 16);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        if (ks * 16 < hd) {
          uint32_t a[4];
          ldmatrix_x4(a, a0 + ks * 32);
          mma_bf16(acc, a, qb[ks][0], qb[ks][1]);
        }
      }
      const int g = (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + lane / 4 + (i / 2) * 8, gi = g + i % 2;
        if (r < nr && gi < heads) sc[gi * cap + r0 + r] = acc[i] * scale;
      }
    }
  }
  __syncthreads();

  // 2. the softmax over the cluster, while the first V tiles load: the
  //    slices' max, then their sums of exps, each combined in rank order;
  //    p normalised, then rounded to bf16
  for (int g = warp; g < heads; g += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < rows; i += 32) m = fmaxf(m, sc[g * cap + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) st[g] = m;
  }
  cluster.sync();
  for (int g = warp; g < heads; g += kWarps) {
    float m = -INFINITY;
    for (int r = 0; r < splits; ++r)
      m = fmaxf(m, cluster.map_shared_rank(st, r)[g]);
    float l = 0.f;
    for (int i = lane; i < rows; i += 32) {
      const float e = expf(sc[g * cap + i] - m);
      sc[g * cap + i] = e;
      l += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0) st[kMaxHeads + g] = l;
  }
  cluster.sync();
  for (int g = warp; g < heads; g += kWarps) {
    float l = 0.f;
    for (int r = 0; r < splits; ++r)
      l += cluster.map_shared_rank(st, r)[kMaxHeads + g];
    for (int i = lane; i < rows; i += 32)
      sc[g * cap + i] = round_bf16(sc[g * cap + i] / l);
  }

  // 3. p.V over the slice's rows: warp w owns the 16-column slices w,
  //    w + 4, ... of every head's output; acc[j][h][0..1]: head lane / 4,
  //    columns 16 (w + 4 j) + 8 h + 2 (lane % 4) + {0, 1} (acc[j][h][2..3]:
  //    the padding heads)
  float acc[kPairs][2][4];
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;
  for (int t = tiles; t < 2 * tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // (the first also publishes p)
    issue(t + kStages - 1);
    const unsigned char* tl = ring + (t % kStages) * kStageBytes;
    const int r0 = (t - tiles) * tile, nr = min(tile, rows - r0);
    const int g = lane / 4;
    const float* pg = sc + g * cap + r0;
    for (int k0 = 0; k0 < nr; k0 += 16) {
      // A: p of head lane / 4 at rows k0 + 2 (lane % 4) + {0, 1} and
      // 8 further; the padding heads 8..15 zero
      const int kr = k0 + (lane % 4) * 2;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kr + (i / 2) * 8 + i % 2;
        p[i] = g < heads && r < nr ? pg[r] : 0.f;
      }
      const uint32_t a[4] = {pack_bf16(p[0], p[1]), 0u,
                             pack_bf16(p[2], p[3]), 0u};
      const unsigned b0 = smem_addr(
          tl + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld
          + (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int col = (warp + kWarps * j) * 16;
        if (col < hd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, b0 + col * 2);
          mma_bf16(acc[j][0], a, bv[0], bv[1]);
          mma_bf16(acc[j][1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is drained and read
  {
    const int g = lane / 4;
    if (g < heads) {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int col = (warp + kWarps * j) * 16;
        if (col < hd) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* dst = o_s + g * hd + col + h * 8 + (lane % 4) * 2;
            dst[0] = acc[j][h][0];
            dst[1] = acc[j][h][1];
          }
        }
      }
    }
  }
  cluster.sync();

  // 4. the slices' partial outputs summed in rank order, each block
  //    writing its share of the (head, column) elements
  for (int e = rank * kThreads + threadIdx.x; e < heads * hd;
       e += splits * kThreads) {
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(o_s, r)[e];
    out[q_row * hd + e] = __float2bfloat16(s);
  }
  cluster.sync();                 // no block leaves while others read it
}

// Raises the kernel's dynamic shared-memory limit to `smem` where the
// default (48 KB) or an earlier call's is lower.
template <int kKSteps>
cudaError_t allow_smem(size_t smem) {
  static size_t configured = 48 * 1024;
  if (smem <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<kKSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) configured = smem;
  return err;
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int splits, size_t smem,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The launch's shape on the current device: the fewest slices (a power of
// two up to kMaxSplits) whose scores fit in a block's shared memory, or
// one and the scores in scratch where none does; then twice as many while
// that keeps at least 64 slots a slice and every one of the B * Hkv
// clusters resident at once (a second wave costs each block's fixed
// latency again: Mistral-NeMo's decode layer took 0.092 ms at 4 slices and
// 0.070 at 2 on an H100).
template <int kKSteps>
int plan(int B, int Hkv, int G, int S_max, int hd, int* splits,
         long long* scratch_bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = 1;
  while (n <= kMaxSplits
         && smem_bytes(G, slice_cap(S_max, n), hd, false)
                > static_cast<size_t>(optin))
    n *= 2;
  const bool spill = n > kMaxSplits;
  if (spill) n = 1;
  while (n < kMaxSplits && S_max >= 128 * n) {
    const size_t smem = smem_bytes(G, slice_cap(S_max, 2 * n), hd, spill);
    err = allow_smem<kKSteps>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t config =
        cluster_config(2 * n, 2 * n, smem, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, decode_attention_kernel<kKSteps>, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<long long>(B) * Hkv > clusters) break;
    n *= 2;
  }
  *splits = n;
  *scratch_bytes = spill ? static_cast<long long>(sizeof(float)) * B * Hkv
                               * n * G * slice_cap(S_max, n)
                         : 0;
  return 0;
}

template <int kKSteps>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* pos_dev, long long pos_host, int B, int Hkv, int G,
           int S_max, int hd, int window, int splits, float scale,
           void* scratch, cudaStream_t stream) {
  const int cap = slice_cap(S_max, splits);
  const size_t smem = smem_bytes(G, cap, hd, scratch != nullptr);
  cudaError_t err = allow_smem<kKSteps>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = cluster_config(
      static_cast<unsigned>(B) * Hkv * splits, splits, smem, attr);
  config.stream = stream;
  err = cudaLaunchKernelEx(
      &config, decode_attention_kernel<kKSteps>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out),
      static_cast<const long long*>(pos_dev), pos_host, Hkv, G, S_max, hd,
      window, scale, cap, static_cast<float*>(scratch));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// f<kKSteps>(args...) with kKSteps the next power of two of hd / 16 (hd a
// multiple of 16 up to 256).
#define DECODE_ATTENTION_DISPATCH(f, hd, ...)                              \
  do {                                                                     \
    const int steps_ = (hd) / 16;                                          \
    if (steps_ <= 1) return f<1>(__VA_ARGS__);                             \
    if (steps_ <= 2) return f<2>(__VA_ARGS__);                             \
    if (steps_ <= 4) return f<4>(__VA_ARGS__);                             \
    if (steps_ <= 8) return f<8>(__VA_ARGS__);                             \
    if (steps_ <= 16) return f<16>(__VA_ARGS__);                           \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  } while (0)

bool valid_shape(int B, int Hkv, int G, int S_max, int hd) {
  return B > 0 && Hkv > 0 && G > 0 && G <= kMaxHeads && S_max > 0
         && hd >= 16 && hd <= 256 && hd % 16 == 0
         && static_cast<long long>(B) * Hkv * kMaxSplits <= 2147483647LL;
}

}  // namespace

extern "C" {

// The launch's cluster size (1 to 8) and the bytes of the scores' scratch
// in device memory (0: they fit in shared memory) for these shapes on the
// current device. Returns 0 or a CUDA error code.
int decode_attention_plan(int B, int Hkv, int G, int S_max, int hd,
                          int* splits, long long* scratch_bytes) {
  if (!valid_shape(B, Hkv, G, S_max, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  DECODE_ATTENTION_DISPATCH(plan, hd, B, Hkv, G, S_max, hd, splits,
                            scratch_bytes);
}

// q (B, 1, Hkv*G, hd), k and v (B, Hkv, S_max, hd), out (B, 1, Hkv*G*hd),
// bf16, contiguous, 16-byte aligned. pos_dev: an int64 on the card, or
// null to use pos_host. window <= 0: none.
// splits and scratch (null, or the scratch's bytes on the card) as
// decode_attention_plan gives them; scale: the score scale. Launches on
// `stream` and returns cudaGetLastError(): a launch the runtime refuses
// never runs, and a later synchronize would not say so.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* pos_dev, long long pos_host,
                         int B, int Hkv, int G, int S_max, int hd, int window,
                         int splits, float scale, void* scratch,
                         void* stream) {
  const auto bits = reinterpret_cast<unsigned long long>(q)
                    | reinterpret_cast<unsigned long long>(k)
                    | reinterpret_cast<unsigned long long>(v);
  if (!valid_shape(B, Hkv, G, S_max, hd) || splits < 1
      || splits > kMaxSplits || (bits & 15ull) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DECODE_ATTENTION_DISPATCH(launch, hd, q, k, v, out, pos_dev,
                            pos_host, B, Hkv, G, S_max, hd, window, splits,
                            scale, scratch,
                            static_cast<cudaStream_t>(stream));
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
