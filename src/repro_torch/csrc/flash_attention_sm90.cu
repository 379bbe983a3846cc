// Causal / sliding-window GQA flash attention (forward) on Hopper's tensor
// cores (sm_90a): bf16 in, fp32 accumulation, bf16 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pl.pallas_call at :116, body _kernel at :33) for bf16
// inputs whose head dim is a multiple of 16 up to 256, on 16-byte-aligned
// tensors. Everything else (fp32, other head dims, unaligned tensors) takes
// the SIMT kernel in flash_attention.cu, which stops at head dim 128; the
// route is chosen in Python (repro_torch/kernels/flash_attention.py::route)
// before the launch.
//
// It computes what flash_attention.cu computes: for batch b, query head h
// and query row i,
//
//   out[b,i,h] = sum_j p_ij v[b,j,h/G] / max(sum_j p_ij, 1e-30)
//   p_ij = exp(s_ij - m_i) on live keys, 0 on masked ones,
//   s_ij = q[b,i,h] . k[b,j,h/G] / sqrt(hd),  m_i = max over live s_ij,
//
// with queries right-aligned at i + Sk - Sq, causal and window masks,
// masked scores at the reference's -2^30, masked p zeroed and l clamped at
// 1e-30 (a row with no live key gives 0), the kv head h / G read in place.
// One rounding differs from the SIMT kernel: p goes to bf16 before the
// P.V product (the tensor cores take bf16 operands), a relative error of
// at most 2^-9 in each p; the denominator l sums the fp32 p. So against
// the plain version the output moves by at most 2^-9 max|v| beyond one
// bf16 ulp (kernels/flash_attention.py::tolerance derives the bound).
//
// What bounds it. At the serving shape (B=4, S=2048, Hq=32, Hkv=8,
// hd=128, causal) the two products are 137 GFLOP against 168 MB of
// traffic: operations bound it, at 0.14 ms on the bf16 tensor cores. The
// SIMT kernel runs those products on the fp32 FMA pipes (67 TFLOP/s), so
// it cannot come within 15x of that bound. This design puts both products
// on wgmma, FlashAttention-3's shape kept as simple as still reaches the
// tensor cores:
//
// * A block of three warpgroups owns one (batch, query head) and 128 query
//   rows (heavy causal tiles first). Warpgroups 0 and 1 consume, 64 query
//   rows each; warpgroup 2 produces: one of its threads issues every load,
//   and setmaxnreg moves registers from it (24) to the consumers (240).
// * TMA feeds the tiles. One tensor map per operand spans the model layout
//   (hd, H, S, B) with its real strides, so nothing is transposed or
//   padded in memory; a box is one head x 64 head-dim columns x 128 rows,
//   128-byte swizzled, and zero fill past S and past hd covers ragged
//   sequences and head dims 16..240 (the smem tile is 64, 128 or 256
//   columns). Q is loaded once; K and V tiles go through a 2-stage ring with
//   mbarrier full (one for K, one for V, so S = Q.K^T starts before V
//   lands) and empty pairs.
// * S = Q.K^T is m64n128k16 wgmma with Q and K from shared memory
//   (K-major). The online softmax runs on the accumulator fragments, row
//   max and sum by quad shuffles, exp2 of pre-scaled scores. P is
//   converted to bf16 in registers and is the register A operand of
//   O += P.V (m64n{64,128}k16); V is the shared-memory B operand read
//   N-major through the transpose bit, so it is never transposed in
//   memory. Accumulation is fp32.
// * Key tiles wholly outside a warpgroup's causal frontier or window are
//   skipped; only diagonal and window-edge tiles (and the ragged last
//   tile) evaluate the mask.
// * Head dims 144..256 (Zamba2-7B's shared attention: 224) pad to 256
//   columns. Q (64 KB), two stages of K and V and 128 query rows fit in
//   the 227 KB of shared memory only with 64-key tiles, so that variant
//   takes 64 keys a tile (S = Q.K^T as m64n64k16, O += P.V as one
//   m64n256k16, 128 accumulator registers a thread); the 64- and
//   128-column variants keep 128-key tiles.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, fetched
// from libcuda through the runtime (cudaGetDriverEntryPoint), so the
// library links against nothing beyond the CUDA runtime.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per block
constexpr int kStages = 2;          // K/V ring depth
constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = 128;      // one 64-column bf16 chunk row
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

// Keys per K/V tile of the HDP-column variant: 128, or 64 at 256 columns
// (what shared memory holds beside Q and two stages).
template <int HDP>
constexpr int key_tile() { return HDP > 128 ? 64 : 128; }

// Shared-memory layout in bytes from a 1024-byte-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes). A tile of R rows is
// HDP / 64 chunks of R x 128 bytes, chunk after chunk.
template <int HDP>
struct Smem {
  static constexpr int kBK = key_tile<HDP>();
  static constexpr int kChunks = HDP / 64;
  static constexpr int kQBytes = kChunks * kBQ * kRowBytes;
  static constexpr int kKVBytes = kChunks * kBK * kRowBytes;  // K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBars = 1 + 3 * kStages;  // q, full_k, full_v, empty
  static constexpr size_t kBytes = kBar + 8 * kBars + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box into shared memory; completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout of an m64nN fp32 accumulator: thread `lane` of warp w
// holds, for register i, row 16 w + lane / 4 + 8 ((i % 4) / 2) and column
// 8 (i / 4) + 2 (lane % 4) + (i % 2).

// d (64 x 128, fp32) += A (64 x 16, bf16, shared) . B (16 x 128, bf16, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, shared) . B (16 x 64, bf16, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, fp32) += A (64 x 16, bf16, registers)
//   . B (16 x 256, bf16, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16, registers)
//   . B (16 x 128, bf16, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16, registers)
//   . B (16 x 64, bf16, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HDP == 256) wgmma_rs_n256(o, a, db);
  else if constexpr (HDP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// S (64 x BK) = Q . K^T's k-step from shared memory.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 128) wgmma_ss_n128(s, da, db, scale_d);
  else wgmma_ss_n64(s, da, db, scale_d);
}

// Is key `key` live for the query at position `pos`?
__device__ __forceinline__ bool key_live(int key, int pos, int Sk,
                                         int causal, int window) {
  return key < Sk && (!causal || key <= pos)
         && (window <= 0 || key > pos - window);
}

// One key tile's online-softmax step on the score fragment s (scaled to
// log2 units in place, then overwritten by p; NS = keys / 2 registers).
// Rows: r0 and r0 + 8 of the tile, at positions pos0 and pos0 + 8; keys
// k0 + column. Returns each row's rescale factor of the old accumulator.
template <bool kMask, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int k0,
                                             int col0, int pos0, int Sk,
                                             int causal, int window) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = s[i] * scale_log2;
    if (kMask) {
      const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
      x = key_live(key, pos0 + 8 * ((i % 4) / 2), Sk, causal, window)
          ? x : kNegInf;
    }
    s[i] = x;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i % 4) / 2;
    float p = exp2f(s[i] - m[r]);
    if (kMask) {
      const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
      p = key_live(key, pos0 + 8 * r, Sk, causal, window) ? p : 0.f;
    }
    s[i] = p;
    sum[r] += p;
  }
  // l stays a per-thread partial sum (the quad shares m and alpha); the
  // quad's partials are added at the end
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                            int Hq, int Hkv, int hd, int causal, int window,
                            float scale_log2) {
  using L = Smem<HDP>;
  constexpr int kBK = L::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heavy tiles first
  const int off = Sk - Sq;                            // right-aligned

  // the key tiles any row of this block can see
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, pos_hi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sQ + c * kBQ * kRowBytes, &qmap, bar_q, 64 * c, h, q0, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(s), L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sK + s * L::kKVBytes + c * kBK * kRowBytes, &kmap,
                   full_k(s), 64 * c, hk, t * kBK, b);
        mbar_expect_tx(full_v(s), L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sV + s * L::kKVBytes + c * kBK * kRowBytes, &vmap,
                   full_v(s), 64 * c, hk, t * kBK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64;                  // this warpgroup's rows
    const int r_a = row0 + warp * 16 + lane / 4;    // and r_a + 8
    const int col0 = 2 * (lane % 4);
    const int wpos_lo = row0 + off;
    const int wpos_hi = min(row0 + 64, Sq) - 1 + off;

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(bar_q, 0);

    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int k0 = t * kBK;
      const bool dead = wpos_hi < wpos_lo || (causal && k0 > wpos_hi)
                        || (window > 0 && k0 + kBK - 1 <= wpos_lo - window);
      mbar_wait(full_k(s), ph);
      if (!dead) {
        float sc[kBK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t chunk = (kk / 4) * kRowBytes;
          const uint32_t kofs = (kk % 4) * 32;
          wgmma_qk<kBK>(
              sc,
              gmma_desc(sQ + chunk * kBQ + wg * 64 * kRowBytes + kofs, 16,
                        1024),
              gmma_desc(sK + s * L::kKVBytes + chunk * kBK + kofs, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        const bool full = k0 + kBK <= Sk
                          && (!causal || k0 + kBK - 1 <= wpos_lo)
                          && (window <= 0 || k0 > wpos_hi - window);
        float alpha[2];
        if (full)
          softmax_tile<false, kBK / 2>(sc, m, l, alpha, scale_log2, k0,
                                       col0, r_a + off, Sk, causal, window);
        else
          softmax_tile<true, kBK / 2>(sc, m, l, alpha, scale_log2, k0,
                                      col0, r_a + off, Sk, causal, window);
#pragma unroll
        for (int j = 0; j < HDP / 2; ++j) o[j] *= alpha[(j % 4) / 2];
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt) {
          pa[kt][0] = pack_bf16(sc[8 * kt + 0], sc[8 * kt + 1]);
          pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
          pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
          pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
        }

        mbar_wait(full_v(s), ph);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt)
          // V N-major: 8-key groups 1024 bytes apart (SBO), 64-column
          // chunks kBK rows apart (LBO)
          wgmma_pv<HDP>(o, pa[kt],
                        gmma_desc(sV + s * L::kKVBytes + kt * 16 * kRowBytes,
                                  kBK * kRowBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      } else {
        mbar_wait(full_v(s), ph);   // the stage is released only once filled
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const long long row_stride = static_cast<long long>(Hq) * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_a + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = out + (static_cast<long long>(b) * Sq + row)
                                      * row_stride
                            + static_cast<long long>(h) * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                    o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over one (B, S, H, hd) bf16 tensor, dims innermost first,
// boxes of 64 head-dim columns x 1 head x `rows` rows, 128-byte swizzle,
// zeros outside the tensor.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
             int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {e * hd, e * hd * H, e * hd * H * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, Sq, Hq, hd, kBQ);
  if (err == 0) err = make_map(&km, k, B, Sk, Hkv, hd, key_tile<HDP>());
  if (err == 0) err = make_map(&vm, v, B, Sk, Hkv, hd, key_tile<HDP>());
  if (err != 0) return err;
  const size_t smem = Smem<HDP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  flash_attention_sm90_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, hd,
      causal, window, scale * 1.4426950408889634f);   // log2(e)
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q, out (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd), contiguous and
// 16-byte aligned; hd a multiple of 16 in [16, 256]. window <= 0 means no
// window; scale is the score scale (1/sqrt(hd)). Launches on `stream` and
// returns cudaGetLastError() (or the tensor-map encoder's refusal).
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Sk, int Hq,
                             int Hkv, int hd, int causal, int window,
                             float scale, void* stream) {
  const auto bits = reinterpret_cast<unsigned long long>(q)
                    | reinterpret_cast<unsigned long long>(k)
                    | reinterpret_cast<unsigned long long>(v)
                    | reinterpret_cast<unsigned long long>(out);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0
      || hd < 16 || hd > 256 || hd % 16 != 0 || (bits & 15ull) != 0
      || (Sq + kBQ - 1) / kBQ > 65535
      || static_cast<long long>(B) * Hq > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                      scale, s);
  if (hd <= 128)
    return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                       scale, s);
  return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, causal, window,
                     scale, s);
}

}  // extern "C"
