// B5d on Hopper (sm_90a): each bf16 Dense layer of the SAC update as one
// wgmma product with its epilogue fused, forward and backward.  The port of
// what XLA fuses around flax's bf16 `Dense` in `sac_train_step`
// (distributed_cluster_gpus_tpu/rl/sac.py:206-310, :246, :264; the layers
// at rl/nets.py:37-39, 58-61, 93-95, 149-150).  The JAX package has no
// Pallas kernel.
//
// dense_fwd_gemm, one forward layer: x [R, K] bf16, kernel W [K, N] bf16,
// bias b [N] bf16:
//   acc = sum_k x[r, k] W[k, n]              (float32, tensor cores, k in
//                                              order, no split-K, no atomics)
//   y   = bf16(float(bf16(acc)) + float(b))   (the product rounded once, then
//                                              torch's bf16 bias add)
//   y   = y > 0 ? y : 0                       (where the layer has a ReLU)
//   out32 = float(y)                          (where given; row stride ld32)
// dense_dx_gemm, a hidden layer's gradient from the layer above's G' [R, K']
// and kernel W' [N, K'] (and, for the actor's hidden layer, a second pair):
//   G  = bf16(G' W'^T)  or  bf16(float(bf16(G' W'^T)) + float(bf16(G2 W2^T)))
//   G  = y > 0 ? G : 0                       (y the layer's bf16 output)
//   db = bf16(tree over the R rows of float(G))
// dense_bwd_kernel, a network's top layer, from a float32 (or bf16)
// incoming gradient g (and optionally a second bf16 g2):
//   G  = bf16(g)  or  bf16(float(g) + float(g2)), masked by y where given
//   db = bf16(tree over the R rows of float(G))
// The trees are ops/physics.py::tree_sum_last's halving tree (rows
// zero-padded to a power of two P; row i + row i + P/2 per level), which
// rl/nets.py::dense_backward applies.  With -fmad=false the epilogues'
// adds are plain __fadd_rn, as torch's.
//
// Bound on the card.  The 16,384-row all-actions layers (B x n_dc x n_g
// rows of the one-hot critic) are bound by bytes: x in, y out (plus the
// float32 copy at a twin's top layer), 17.0 MB for a 16,384 x 272 -> 256
// layer, 5.1 us at 3.35 TB/s, against 2.3 us of bf16 tensor work at 989
// TF.  The 256-row layers move ~0.3 MB and do ~34 MFLOP: latency.
//
// Design.
// * Forward: a block owns a BM x BN tile of y (BM = 64 x its warpgroups).
//   Thread 0 issues TMA loads (128-byte swizzle) of 64-deep k-tiles of x
//   and W into a ring of shared-memory stages completed on mbarriers, as
//   many as the ring holds from the start; a stage is refilled when K needs
//   more tiles than the ring has, after every warpgroup's products on it
//   are done.  Each warpgroup runs wgmma m64nBNk16 on its 64 rows (x
//   K-major, W N-major from its row-major [K, N] layout), the sum in
//   registers.  The epilogue rounds the sums to bf16 into a tile in shared
//   memory, then adds the bias (staged in shared memory), applies the ReLU
//   and stores whole rows in 16-byte pieces (and the float32 copy): y makes
//   one trip through device memory.  The 16,384-row layers take 128 x 128
//   tiles with a ring of three (two blocks an SM, one's epilogue under the
//   other's loads), the 256-row layers 64 x 64 tiles with the whole K in
//   flight (kernels/dense.py::fwd_plan; PERF.md §6 has the timed
//   alternatives).  Narrow layers (N = 8, 32) run a 64-wide tile whose
//   extra columns TMA fills with zeros and the epilogue does not store.
// * An operand TMA cannot describe (a row stride that is not a multiple of
//   16 bytes: the encoder's first layer, K = 49, 98-byte rows) is loaded by
//   the block's threads into the same swizzled layout before the loop; its
//   K must then fit the ring (the wrapper's plan checks).
// * dX: a block owns 16 columns of all R <= 256 rows (four warpgroups of 64
//   rows), so the bias gradient's tree over the rows stays in the block:
//   wgmma m64n16k16 with both operands K-major (W' is [N, K'] row-major),
//   then the epilogue rounds (and sums the second product), masks by y,
//   writes G and puts float(G) in shared memory, and one warp a column runs
//   the tree: the levels of 128, 64 and 32 rows in registers (a lane holds
//   rows l, l + 32, ...), the last five by __shfl_down_sync.  No atomics.
//   The mask's y is loaded before any store of G.
// * The top layers' standalone backward (dense_bwd_kernel): a block owns 8
//   columns; two neighbouring threads read a row's 8 columns as 16-byte
//   vectors, each thread its two rows (r and r + 128) before any store;
//   the same register-and-shuffle tree follows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // k-tile depth, and a 128-byte swizzle row
constexpr int kRowBytes = 128;   // one swizzled row of 64 bf16
constexpr int kDxBN = 16;        // dX: columns a block owns
constexpr int kDxRows = 256;     // dX: rows a block owns (4 warpgroups)
constexpr int kBwdCols = 8;      // standalone backward: columns a block owns
constexpr int kMaxTreeRows = 256;

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// a [box rows x 64] tile at (col0, row0) of a 2-D tensor map into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col0),
      "r"(row0)
      : "memory");
}

// fetch a tensor map into the cache ahead of its first TMA load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// ------------------------------------------------------------ wgmma

// D[64 x 16] += A[64 x 16] * B[16 x 16], both operands in shared memory
// (descriptors); TB: 0 for a K-major B, 1 for an N-major one
template <int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], both operands in shared memory
// (descriptors); TB: 0 for a K-major B, 1 for an N-major one
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], both operands in shared memory
// (descriptors); TB: 0 for a K-major B, 1 for an N-major one
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256], both operands in shared memory
// (descriptors); TB: 0 for a K-major B, 1 for an N-major one
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}


// ------------------------------------------------------- shared pieces

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// rows [row0, row0 + box_rows) x columns [col0, col0 + 64) of a row-major
// bf16 matrix (rows x cols, row stride ld) into shared memory as TMA's
// 128-byte swizzle lays a box out (row r's 16-byte chunk c at r * 128 +
// (c ^ r % 8) * 16), zeros outside the matrix; by every thread of the block
__device__ void load_box(uint8_t* dst, const bf16* __restrict__ src,
                         long long ld, int rows, int cols, int row0, int col0,
                         int box_rows) {
  for (int e = threadIdx.x; e < box_rows * kTile; e += blockDim.x) {
    const int r = e / kTile, c = e % kTile;
    const int gr = row0 + r, gc = col0 + c;
    bf16 v = __ushort_as_bfloat16(0);
    if (gr < rows && gc < cols) v = src[(long long)gr * ld + gc];
    const int chunk = (c / 8) ^ (r % 8);
    *reinterpret_cast<bf16*>(dst + r * kRowBytes + chunk * 16 + (c % 8) * 2) = v;
  }
}

__device__ __forceinline__ void fence_generic_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The halving tree over the P rows (P a power of two, 64 <= P <= 256) of
// column c of s (row stride `stride` floats), by one warp: lane l holds
// rows l, l + 32, ...; the levels of 128, 64 and 32 rows run in registers,
// the last five by shuffles.  The sum ends in lane 0.
__device__ __forceinline__ float column_tree(const float* s, int stride, int c,
                                             int P) {
  const int lane = threadIdx.x % 32;
  float v[kMaxTreeRows / 32];
#pragma unroll
  for (int k = 0; k < kMaxTreeRows / 32; ++k)
    v[k] = 32 * k < P ? s[(lane + 32 * k) * stride + c] : 0.0f;
#pragma unroll
  for (int h = kMaxTreeRows / 64; h >= 1; h >>= 1)
    if (64 * h <= P) {
#pragma unroll
      for (int k = 0; k < h; ++k) v[k] = __fadd_rn(v[k], v[k + h]);
    }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
    v[0] = __fadd_rn(v[0], __shfl_down_sync(0xffffffffu, v[0], h));
  return v[0];
}

// ------------------------------------------------------------- forward

struct FwdArgs {
  const bf16* x;
  const bf16* w;
  const bf16* bias;
  bf16* y;
  float* out32;
  long long ldx, ld32;
  int R, K, N, kt, stages, ring_bytes, relu, x_tma, w_tma, vec32;
};

// the layer's output from the product rounded to bf16 (p) and the bias
__device__ __forceinline__ bf16 fwd_out(bf16 p, bf16 b, int relu) {
  bf16 r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(b)));
  if (relu && !(__bfloat162float(r) > 0.0f)) r = __ushort_as_bfloat16(0);
  return r;
}

// thread 0: arm stage kt % stages and issue k-tile kt's TMA loads
template <int BM, int BN>
__device__ __forceinline__ void fwd_issue(uint8_t* smem, uint64_t* full,
                                          const CUtensorMap* mx,
                                          const CUtensorMap* mw,
                                          const FwdArgs& a, int kt, int m0,
                                          int n0) {
  constexpr int A_BYTES = BM * kRowBytes, STAGE = (BM + BN) * kRowBytes;
  const int s = kt % a.stages;
  uint8_t* st = smem + s * STAGE;
  const uint32_t tx = (a.x_tma ? A_BYTES : 0) + (a.w_tma ? BN * kRowBytes : 0);
  mbar_arrive_tx(&full[s], tx);
  if (a.x_tma) tma_load(st, mx, &full[s], kt * kTile, m0);
  if (a.w_tma)
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load(st + A_BYTES + j * 64 * kRowBytes, mw, &full[s], n0 + 64 * j,
               kt * kTile);
}

template <int N>
__device__ __forceinline__ void fwd_mma(float (&acc)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void fwd_mma<64>(float (&acc)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  wgmma_n64<1>(acc, da, db, scale_d);
}
template <>
__device__ __forceinline__ void fwd_mma<128>(float (&acc)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_n128<1>(acc, da, db, scale_d);
}
template <>
__device__ __forceinline__ void fwd_mma<256>(float (&acc)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_n256<1>(acc, da, db, scale_d);
}

template <int WG, int BN>
__global__ void __launch_bounds__(WG * 128, BN <= 128 ? 2 : 1)
    dense_fwd_gemm(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  constexpr int BM = 64 * WG;
  constexpr int A_BYTES = BM * kRowBytes, STAGE = (BM + BN) * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // the ring (which the epilogue's tile reuses), its mbarriers, the bias
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.ring_bytes);
  bf16* bias_s = reinterpret_cast<bf16*>(  // 16-byte aligned
      smem + a.ring_bytes + ((a.stages * 8 + 15) & ~15));
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool tma = a.x_tma || a.w_tma;
  // thread 0 sets up the ring and puts its loads in flight at once; the
  // block stages the bias meanwhile (nobody waits on the ring before the
  // barrier below)
  if (tid == 0) {
    if (a.x_tma) prefetch_map(&map_x);
    if (a.w_tma) prefetch_map(&map_w);
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tma)
      for (int kt = 0; kt < a.kt && kt < a.stages; ++kt)
        fwd_issue<BM, BN>(smem, full, &map_x, &map_w, a, kt, m0, n0);
  }
  for (int c = tid; c < BN; c += blockDim.x)
    bias_s[c] = n0 + c < a.N ? a.bias[n0 + c] : __ushort_as_bfloat16(0);
  if (!a.x_tma || !a.w_tma) {  // the whole K is in the ring (the plan checks)
    for (int kt = 0; kt < a.kt; ++kt) {
      uint8_t* st = smem + kt * STAGE;
      if (!a.x_tma) load_box(st, a.x, a.ldx, a.R, a.K, m0, kt * kTile, BM);
      if (!a.w_tma)
        for (int j = 0; j < BN / 64; ++j)
          load_box(st + A_BYTES + j * 64 * kRowBytes, a.w, a.N, a.K, a.N,
                   kt * kTile, n0 + 64 * j, kTile);
    }
    fence_generic_to_async();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < a.kt; ++kt) {
    const int s = kt % a.stages;
    if (tma) mbar_wait(&full[s], (kt / a.stages) & 1);
    // x: K-major, this warpgroup's 64 rows; a k16 step is 32 bytes along a
    // swizzled row.  W: N-major, 64-column chunks 64 rows apart (LBO), eight
    // k rows a 1,024-byte swizzle atom (SBO); a k16 step is 16 rows.
    const uint32_t sa = smem_u32(smem + s * STAGE) + wg * 64 * kRowBytes;
    const uint32_t sb = smem_u32(smem + s * STAGE + A_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks)
      fwd_mma<BN>(acc, desc(sa + ks * 32, 16, 1024),
                  desc(sb + ks * 16 * kRowBytes, 64 * kRowBytes, 1024),
                  (kt | ks) != 0);
    wgmma_commit();
    fence_regs(acc);
    if (kt + a.stages < a.kt) {  // refill this stage: every product on it done
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();
      if (tid == 0)
        fwd_issue<BM, BN>(smem, full, &map_x, &map_w, a, kt + a.stages, m0, n0);
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // epilogue.  Thread (warp w, lane l) of a warpgroup holds rows 16w + l/4
  // (+8) and columns 8n + 2(l % 4) (+1) of the product: rounded to bf16,
  // they go to a [BM x BN] tile in shared memory (the ring is free now;
  // rows padded by 16 bytes, so the pairs of a warp hit distinct banks),
  // then the block adds the bias, applies the ReLU and stores whole rows
  // in 16-byte pieces.
  constexpr int TS = BN + 8;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  __syncthreads();  // every warpgroup's products are done with the ring
  const int w = (tid % 128) / 32, l = tid % 32;
  const int r_a = wg * 64 + w * 16 + l / 4;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tile + (r_a + 8 * j) * TS + 8 * n +
                                         2 * (l % 4)) =
          __halves2bfloat162(__float2bfloat16_rn(acc[4 * n + 2 * j]),
                             __float2bfloat16_rn(acc[4 * n + 2 * j + 1]));
  __syncthreads();
  const bool vec = a.N % 8 == 0;
  for (int e = tid; e < BM * BN / 8; e += blockDim.x) {
    const int r = e / (BN / 8), c = 8 * (e % (BN / 8));
    const int row = m0 + r, col = n0 + c;
    if (row >= a.R || col >= a.N) continue;
    const uint4 pu = *reinterpret_cast<const uint4*>(tile + r * TS + c);
    const uint4 bu = *reinterpret_cast<const uint4*>(bias_s + c);
    const uint32_t pw[4] = {pu.x, pu.y, pu.z, pu.w};
    const uint32_t bw[4] = {bu.x, bu.y, bu.z, bu.w};
    uint32_t ow[4];
    bf16 ov[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // element k: half k % 2 of word k / 2
      const int sh = 16 * (k % 2);
      ov[k] = fwd_out(__ushort_as_bfloat16((unsigned short)(pw[k / 2] >> sh)),
                      __ushort_as_bfloat16((unsigned short)(bw[k / 2] >> sh)),
                      a.relu);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ow[k] = (uint32_t)__bfloat16_as_ushort(ov[2 * k]) |
              ((uint32_t)__bfloat16_as_ushort(ov[2 * k + 1]) << 16);
    const uint4 ou = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    bf16* yr = a.y + (long long)row * a.N + col;
    float* o = a.out32 == nullptr ? nullptr : a.out32 + (long long)row * a.ld32 + col;
    if (vec) {
      *reinterpret_cast<uint4*>(yr) = ou;
    } else {
      for (int k = 0; k < 8 && col + k < a.N; ++k) yr[k] = ov[k];
    }
    if (o != nullptr) {
      if (vec && a.vec32) {
        *reinterpret_cast<float4*>(o) =
            make_float4(__bfloat162float(ov[0]), __bfloat162float(ov[1]),
                        __bfloat162float(ov[2]), __bfloat162float(ov[3]));
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(__bfloat162float(ov[4]), __bfloat162float(ov[5]),
                        __bfloat162float(ov[6]), __bfloat162float(ov[7]));
      } else {
        for (int k = 0; k < 8 && col + k < a.N; ++k) o[k] = __bfloat162float(ov[k]);
      }
    }
  }
}

// ------------------------------------------------------------------ dX

struct DxArgs {
  const bf16* g[2];
  const bf16* w[2];
  long long ldg[2], ldw[2];
  int kc[2], kt[2], g_tma[2], w_tma[2];
  const bf16* y;
  bf16* G;
  bf16* db;
  int R, N, P, stages, n_kt;
};

__device__ __forceinline__ uint32_t dx_tx(const DxArgs& a, int p) {
  return (a.g_tma[p] ? kDxRows * kRowBytes : 0) +
         (a.w_tma[p] ? kDxBN * kRowBytes : 0);
}

// thread 0: arm stage t % stages and issue tile t's TMA loads (tile t is
// k-tile t of the first product, then those of the second)
__device__ __forceinline__ void dx_issue(uint8_t* smem, uint64_t* full,
                                         const CUtensorMap* mg,
                                         const CUtensorMap* mw,
                                         const DxArgs& a, int t, int n0) {
  constexpr int A_BYTES = kDxRows * kRowBytes;
  constexpr int STAGE = (kDxRows + kDxBN) * kRowBytes;
  const int p = t < a.kt[0] ? 0 : 1, kk = p ? t - a.kt[0] : t;
  const int s = t % a.stages;
  uint8_t* st = smem + s * STAGE;
  mbar_arrive_tx(&full[s], dx_tx(a, p));
  if (a.g_tma[p]) tma_load(st, mg + p, &full[s], kk * kTile, 0);
  if (a.w_tma[p]) tma_load(st + A_BYTES, mw + p, &full[s], kk * kTile, n0);
}

struct DxMaps {
  CUtensorMap g[2], w[2];
};

template <int NP>
__global__ void __launch_bounds__(512, 1)
    dense_dx_gemm(const __grid_constant__ DxMaps maps, const DxArgs a) {
  constexpr int A_BYTES = kDxRows * kRowBytes;
  constexpr int STAGE = (kDxRows + kDxBN) * kRowBytes;
  constexpr int TS = kDxBN + 1;  // the tree's row stride (no bank conflicts)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* tree = reinterpret_cast<float*>(smem + a.stages * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(tree + kDxRows * TS);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kDxBN;
  // thread 0 sets up the ring and puts its loads in flight at once; the
  // block loads the mask's y meanwhile (into registers, before any store:
  // a store to G could alias it)
  if (tid == 0) {
    for (int p = 0; p < NP; ++p) {
      if (a.g_tma[p]) prefetch_map(&maps.g[p]);
      if (a.w_tma[p]) prefetch_map(&maps.w[p]);
    }
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < a.n_kt && t < a.stages; ++t)
      if (dx_tx(a, t < a.kt[0] ? 0 : 1))
        dx_issue(smem, full, maps.g, maps.w, a, t, n0);
  }
  const int w = (tid % 128) / 32, l = tid % 32;
  const int row_a = wg * 64 + w * 16 + l / 4;
  constexpr int NV = kDxBN / 2;
  float yv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int row = row_a + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    yv[i] = a.y == nullptr ? 1.0f
            : row < a.R && col < a.N ? __bfloat162float(a.y[(long long)row * a.N + col])
                                     : 0.0f;
  }
  bool manual = false;
  for (int p = 0; p < NP; ++p) manual |= !a.g_tma[p] || !a.w_tma[p];
  if (manual) {  // every tile is in the ring (the plan checks)
    for (int t = 0; t < a.n_kt; ++t) {
      const int p = t < a.kt[0] ? 0 : 1, kk = p ? t - a.kt[0] : t;
      uint8_t* st = smem + t * STAGE;
      if (!a.g_tma[p])
        load_box(st, a.g[p], a.ldg[p], a.R, a.kc[p], 0, kk * kTile, kDxRows);
      if (!a.w_tma[p])
        load_box(st + A_BYTES, a.w[p], a.ldw[p], a.N, a.kc[p], n0, kk * kTile,
                 kDxBN);
    }
    fence_generic_to_async();
  }
  __syncthreads();

  float acc[2][kDxBN / 2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < kDxBN / 2; ++i) acc[p][i] = 0.0f;
  for (int t = 0; t < a.n_kt; ++t) {
    const int p = NP == 1 || t < a.kt[0] ? 0 : 1, kk = p ? t - a.kt[0] : t;
    const int s = t % a.stages;
    if (dx_tx(a, p)) mbar_wait(&full[s], (t / a.stages) & 1);
    // both operands K-major: a k16 step is 32 bytes along a swizzled row,
    // eight rows a 1,024-byte atom
    const uint32_t sa = smem_u32(smem + s * STAGE) + wg * 64 * kRowBytes;
    const uint32_t sb = smem_u32(smem + s * STAGE + A_BYTES);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const uint64_t da = desc(sa + ks * 32, 16, 1024);
      const uint64_t db = desc(sb + ks * 32, 16, 1024);
      if (p == 0)
        wgmma_n16<0>(acc[0], da, db, (kk | ks) != 0);
      else
        wgmma_n16<0>(acc[1], da, db, (kk | ks) != 0);
    }
    wgmma_commit();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (t + a.stages < a.n_kt) {
      wgmma_wait_all();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      __syncthreads();
      if (tid == 0) dx_issue(smem, full, maps.g, maps.w, a, t + a.stages, n0);
    }
  }
  wgmma_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // epilogue: round (and sum the second product), mask, write G and the
  // tree's rows (zeros past R and N)
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int row = row_a + 8 * ((i / 2) % 2);
    const int cl = 8 * (i / 4) + 2 * (l % 4) + i % 2, col = n0 + cl;
    bf16 v = __float2bfloat16_rn(acc[0][i]);
    if (NP == 2)
      v = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(v), __bfloat162float(__float2bfloat16_rn(acc[1][i]))));
    const bool in = row < a.R && col < a.N;
    if (!(yv[i] > 0.0f)) v = __ushort_as_bfloat16(0);
    if (in) a.G[(long long)row * a.N + col] = v;
    tree[row * TS + cl] = in ? __bfloat162float(v) : 0.0f;
  }
  __syncthreads();
  const int c = tid / 32;  // one warp a column (16 warps, 16 columns)
  const float sum = column_tree(tree, TS, c, a.P);
  if (l == 0 && n0 + c < a.N) a.db[n0 + c] = __float2bfloat16_rn(sum);
}

// ---------------------------------------------- standalone top-layer backward

// one element of G from its raw inputs (the incoming gradient g as float,
// the second one g2 (0 when there is none), the layer's output y (1 when
// there is no ReLU))
__device__ __forceinline__ bf16 grad_of(float g, int g_f32, int two, float g2,
                                        float y) {
  bf16 v = __float2bfloat16_rn(g);  // exact for a bf16 g
  if (!g_f32 && two) v = __float2bfloat16_rn(__fadd_rn(g, g2));
  if (!(y > 0.0f)) v = __ushort_as_bfloat16(0);
  return v;
}

__global__ void __launch_bounds__(256)
    dense_bwd_kernel(const void* __restrict__ g, int g_f32, long long ldg,
                     const bf16* __restrict__ g2, const bf16* __restrict__ y,
                     bf16* __restrict__ G, bf16* __restrict__ db, int R, int N,
                     int P, int vec) {
  constexpr int TS = kBwdCols + 1;
  constexpr int kHalf = kMaxTreeRows / 2;
  __shared__ float s[kMaxTreeRows * TS];
  const int c0 = blockIdx.x * kBwdCols;
  const int q = threadIdx.x % 2, col = c0 + 4 * q;  // 4 columns a thread
  const int two = g2 != nullptr;
  // rows r and r + 128 of this thread: every input loaded before any store
  float gv[2][4], g2v[2][4], yv[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = threadIdx.x / 2 + h * kHalf;
    const long long gi = (long long)r * ldg + col, ri = (long long)r * N + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[h][e] = 0.0f, g2v[h][e] = 0.0f, yv[h][e] = 1.0f;
    if (r >= R) continue;
    if (vec && col + 3 < N) {  // 16-byte loads of a float32 gradient
      if (g_f32) {
        const float4 u = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(g) + gi);
        gv[h][0] = u.x, gv[h][1] = u.y, gv[h][2] = u.z, gv[h][3] = u.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const bf16*>(g) + gi);
        const bf16* b = reinterpret_cast<const bf16*>(&u);
        for (int e = 0; e < 4; ++e) gv[h][e] = __bfloat162float(b[e]);
      }
      if (two) {
        const uint2 u = *reinterpret_cast<const uint2*>(g2 + ri);
        const bf16* b = reinterpret_cast<const bf16*>(&u);
        for (int e = 0; e < 4; ++e) g2v[h][e] = __bfloat162float(b[e]);
      }
      if (y != nullptr) {
        const uint2 u = *reinterpret_cast<const uint2*>(y + ri);
        const bf16* b = reinterpret_cast<const bf16*>(&u);
        for (int e = 0; e < 4; ++e) yv[h][e] = __bfloat162float(b[e]);
      }
    } else {
      for (int e = 0; e < 4 && col + e < N; ++e) {
        gv[h][e] = g_f32 ? reinterpret_cast<const float*>(g)[gi + e]
                         : __bfloat162float(reinterpret_cast<const bf16*>(g)[gi + e]);
        if (two) g2v[h][e] = __bfloat162float(g2[ri + e]);
        if (y != nullptr) yv[h][e] = __bfloat162float(y[ri + e]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = threadIdx.x / 2 + h * kHalf;
    const long long ri = (long long)r * N + col;
    bf16 out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = r < R && col + e < N;
      out[e] = in ? grad_of(gv[h][e], g_f32, two, g2v[h][e], yv[h][e])
                  : __ushort_as_bfloat16(0);
      s[r * TS + 4 * q + e] = __bfloat162float(out[e]);
    }
    if (r >= R) continue;
    if (vec && col + 3 < N) {
      uint2 u;
      bf16* ub = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) ub[e] = out[e];
      *reinterpret_cast<uint2*>(G + ri) = u;
    } else {
      for (int e = 0; e < 4 && col + e < N; ++e) G[ri + e] = out[e];
    }
  }
  __syncthreads();
  const int c = threadIdx.x / 32;  // one warp a column
  const float sum = column_tree(s, TS, c, P);
  if (threadIdx.x % 32 == 0 && c0 + c < N) db[c0 + c] = __float2bfloat16_rn(sum);
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found in the copy of libcuda the CUDA
// runtime has loaded (no link flag)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 2-D map of a row-major bf16 matrix (rows x cols, row stride ld) in
// boxes of box_rows x 64 with the 128-byte swizzle; zeros outside it
int make_map(CUtensorMap* m, const void* base, long long rows, long long cols,
             long long ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTile, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

bool tma_ok(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * 2) % 16 == 0;
}

constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// the ring (at least the epilogue's BM x (BN + 8) bf16 tile, which reuses
// it), its mbarriers and the tile's bias
int fwd_ring(int bm, int bn, int stages) {
  const int ring = stages * (bm + bn) * kRowBytes, tile = bm * (bn + 8) * 2;
  return ring > tile ? ring : tile;
}

int fwd_smem(int bm, int bn, int stages) {
  return 1024 + fwd_ring(bm, bn, stages) + stages * 8 + 16 + bn * 2;
}

int dx_smem(int stages) {
  return 1024 + stages * (kDxRows + kDxBN) * kRowBytes +
         kDxRows * (kDxBN + 1) * 4 + stages * 8;
}

template <int WG, int BN>
int fwd_launch(const CUtensorMap& mx, const CUtensorMap& mw, const FwdArgs& a,
               cudaStream_t stream) {
  static bool attr = false;
  const int smem = fwd_smem(64 * WG, BN, a.stages);
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_fwd_gemm<WG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((a.R + 64 * WG - 1) / (64 * WG), (a.N + BN - 1) / BN);
  dense_fwd_gemm<WG, BN><<<grid, WG * 128, smem, stream>>>(mx, mw, a);
  return (int)cudaGetLastError();
}

template <int NP>
int dx_launch(const DxMaps& maps, const DxArgs& a, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_dx_gemm<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int blocks = (a.N + kDxBN - 1) / kDxBN;
  dense_dx_gemm<NP><<<blocks, 512, dx_smem(a.stages), stream>>>(maps, a);
  return (int)cudaGetLastError();
}

bool rows_ok(int R) { return R >= 64 && R % 64 == 0; }

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns its launch's
// cudaError_t, -1 for a shape or plan the kernel does not take, -2 when
// libcuda's tensor-map encoder is missing, -3 when it refuses an operand.
//
// Forward: x (bf16 [R, K], row stride ldx, unit column stride), w (bf16
// [K, N] contiguous), bias (bf16 [N]); writes y (bf16 [R, N] contiguous)
// and, where out32 is not 0, its float32 copy (row stride ld32, unit
// column stride).  bm in {64, 128}, bn in {64, 256} and the ring's stages
// come from the wrapper's plan (kernels/dense.py::fwd_plan).
extern "C" int dense_fwd_launch(const void* x, long long ldx, const void* w,
                                const void* bias, void* y, void* out32,
                                long long ld32, int R, int K, int N, int relu,
                                int bm, int bn, int stages, void* stream) {
  if (!rows_ok(R) || K < 1 || N < 1 || ldx < K || stages < 1 ||
      fwd_smem(bm, bn, stages) > kSmemMax)
    return -1;
  FwdArgs a;
  a.x = reinterpret_cast<const bf16*>(x);
  a.w = reinterpret_cast<const bf16*>(w);
  a.bias = reinterpret_cast<const bf16*>(bias);
  a.y = reinterpret_cast<bf16*>(y);
  a.out32 = reinterpret_cast<float*>(out32);
  a.ldx = ldx;
  a.ld32 = ld32;
  a.R = R, a.K = K, a.N = N, a.relu = relu, a.stages = stages;
  a.ring_bytes = fwd_ring(bm, bn, stages);
  a.kt = (K + kTile - 1) / kTile;
  a.x_tma = tma_ok(x, ldx);
  a.w_tma = tma_ok(w, N);
  a.vec32 = out32 != nullptr && ld32 % 4 == 0 &&
            reinterpret_cast<uintptr_t>(out32) % 16 == 0;
  if ((!a.x_tma || !a.w_tma) && a.kt > stages) return -1;
  CUtensorMap mx = {}, mw = {};
  int rc;
  if (a.x_tma && (rc = make_map(&mx, x, R, K, ldx, bm)) != 0) return rc;
  if (a.w_tma && (rc = make_map(&mw, w, K, N, N, kTile)) != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return fwd_launch<1, 64>(mx, mw, a, s);
  if (bm == 128 && bn == 64) return fwd_launch<2, 64>(mx, mw, a, s);
  if (bm == 128 && bn == 256) return fwd_launch<2, 256>(mx, mw, a, s);
  if (bm == 64 && bn == 256) return fwd_launch<1, 256>(mx, mw, a, s);
  if (bm == 128 && bn == 128) return fwd_launch<2, 128>(mx, mw, a, s);
  if (bm == 64 && bn == 128) return fwd_launch<1, 128>(mx, mw, a, s);
  return -1;
}

// dX: G = mask(bf16(g w^T)) (or the rounded sum of two such products, g2
// and w2 given), writes G (bf16 [R, N] contiguous) and db (bf16 [N]), the
// tree over its rows.  g (bf16 [R, kc], row stride ldg), w (bf16 [N, kc],
// row stride ldw: the layer above's kernel), likewise g2 and w2 (kc2 deep)
// or 0; y (bf16 [R, N] contiguous) the layer's output, or 0 for no mask.
// R <= 256; the ring's stages come from kernels/dense.py::dx_plan.
extern "C" int dense_dx_launch(const void* g, long long ldg, const void* w,
                               long long ldw, int kc, const void* g2,
                               long long ldg2, const void* w2, long long ldw2,
                               int kc2, const void* y, void* G, void* db, int R,
                               int N, int stages, void* stream) {
  const int np = g2 != nullptr ? 2 : 1;
  if (!rows_ok(R) || R > kDxRows || N < 1 || kc < 1 || ldg < kc || ldw < kc ||
      (np == 2 && (kc2 < 1 || ldg2 < kc2 || ldw2 < kc2)) || stages < 1 ||
      dx_smem(stages) > kSmemMax)
    return -1;
  DxArgs a;
  DxMaps maps = {};
  const void* gs[2] = {g, g2};
  const void* ws[2] = {w, w2};
  const long long lgs[2] = {ldg, ldg2}, lws[2] = {ldw, ldw2};
  const int kcs[2] = {kc, kc2};
  bool manual = false;
  for (int p = 0; p < 2; ++p) {
    a.g[p] = reinterpret_cast<const bf16*>(gs[p]);
    a.w[p] = reinterpret_cast<const bf16*>(ws[p]);
    a.ldg[p] = lgs[p], a.ldw[p] = lws[p];
    a.kc[p] = p < np ? kcs[p] : 0;
    a.kt[p] = (a.kc[p] + kTile - 1) / kTile;
    a.g_tma[p] = p < np && tma_ok(gs[p], lgs[p]);
    a.w_tma[p] = p < np && tma_ok(ws[p], lws[p]);
    if (p < np) manual |= !a.g_tma[p] || !a.w_tma[p];
    int rc;
    if (a.g_tma[p] && (rc = make_map(&maps.g[p], gs[p], R, kcs[p], lgs[p], kDxRows)) != 0)
      return rc;
    if (a.w_tma[p] && (rc = make_map(&maps.w[p], ws[p], N, kcs[p], lws[p], kDxBN)) != 0)
      return rc;
  }
  a.y = reinterpret_cast<const bf16*>(y);
  a.G = reinterpret_cast<bf16*>(G);
  a.db = reinterpret_cast<bf16*>(db);
  a.R = R, a.N = N, a.P = 64, a.stages = stages;
  while (a.P < R) a.P <<= 1;
  a.n_kt = a.kt[0] + a.kt[1];
  if (manual && a.n_kt > stages) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return np == 2 ? dx_launch<2>(maps, a, s) : dx_launch<1>(maps, a, s);
}

// The standalone backward of a network's top layer: g the incoming gradient
// ([R, N] at row stride ldg, unit column stride; float32 when g_f32, else
// bf16), g2 a second bf16 one ([R, N] contiguous, only with a bf16 g) or 0,
// y the layer's bf16 output ([R, N] contiguous) when it has a ReLU, else 0;
// writes G (bf16 [R, N], contiguous) and db (bf16 [N]).  R <= 256.
extern "C" int dense_bwd_launch(const void* g, int g_f32, long long ldg,
                                const void* g2, const void* y, void* G,
                                void* db, int R, int N, void* stream) {
  if (!rows_ok(R) || R > kMaxTreeRows || N < 1 || ldg < N ||
      (g_f32 && g2 != nullptr))
    return -1;
  int P = 64;
  while (P < R) P <<= 1;
  const int vec = N % 4 == 0 && ldg % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % (g_f32 ? 16 : 8) == 0;
  const int blocks = (N + kBwdCols - 1) / kBwdCols;
  dense_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      g, g_f32, ldg, reinterpret_cast<const bf16*>(g2),
      reinterpret_cast<const bf16*>(y), reinterpret_cast<bf16*>(G),
      reinterpret_cast<bf16*>(db), R, N, P, vec);
  return (int)cudaGetLastError();
}
