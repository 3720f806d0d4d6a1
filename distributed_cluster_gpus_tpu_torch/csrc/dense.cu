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
// critic_first_gemm, the one-hot critic's first layer (B5e folded into its
// A operand): the same layer with the ReLU, x [R, L + n_dc + n_g] the
// critic's input rows (rl/nets.py::critic_input: the JAX package's concat
// and cast at rl/nets.py:85-87 and its all_actions tiling at :98-112),
// which the block builds in shared memory from the float32 latents and the
// row index (every joint action) or the taken actions, never reading x
// from device memory; for the taken actions it also writes the rows it
// built (the first layer's dW reads them).
// actor_heads_gemm, the actor's two heads and their masked log-softmax
// (B5f's forward; rl/nets.py:58-66): one product with k_dc and k_g side by
// side in W's tile, each logit rounded and its head's bias added as above,
// written as float32, then per (row, head) x = mask ? l : -1e9, m = max x
// (NaN wins), S = the halving tree of exp(x - m), logp = (x - m) - log(S),
// rl/nets.py::masked_log_softmax's arithmetic op for op (expf, logf:
// torch's).
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
// TF.  The critic's first layer built from the latents moves 8.7 MB (y
// out, W and 0.26 MB of latents): 2.6 us against 2.3 us of tensor work.
// The 256-row layers move ~0.3 MB and do ~34 MFLOP: latency; so do the
// actor's heads (~0.17 MB, 2 x 256 x 16 logits).
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
// * The critic's rows are built the same way, 16 bytes a store, from the
//   latent rows the block's rows use, which one TMA copy stages in shared
//   memory behind the ring at the start (2-3 rows of 1 KB for 128 rows of
//   every joint action at A = 64; the block's own rows for the taken
//   actions, whose actions its threads stage beside them), so a build
//   reads shared memory only.  The product sees the bf16 operands TMA
//   would have loaded, in the same k order: bitwise the layer on
//   critic_input's rows.  For every joint action with A a multiple of 64,
//   a warpgroup's 64 rows share one latent: a latent k-tile is 8 copies of
//   it (one 1,024-byte swizzle atom) that the products read with a stride
//   byte offset of 0 between 8-row groups, so only the one-hot k-tile is
//   built row by row.  Rows are built after each k-tile's products are
//   retired (ptxas serializes every product of a loop that runs other code
//   while one is in flight): k-tile kt + 1's rows into a stage not yet
//   filled, and kt's stage refilled.  W arrives by TMA on the stage's
//   mbarrier (its expected bytes W's alone) and every warp arrives on it
//   after its rows and a proxy fence.  Generic stores into shared memory
//   are fenced (fence.proxy.async) before the asynchronous products read
//   them.
// * The heads' kernels (4- or 16-byte rows, side by side in one tile of
//   64, 128, 192 or 256 columns: one wgmma a k16 step holds whole rows) are
//   loaded by the block's threads; the log-softmax runs one thread per
//   (row, head), a warp on one head, its exponentials taken as the tree
//   needs them (rd::tree_regs, at most 9 partial sums live: no scratch, no
//   local memory).
// * Rows: the forward takes any R >= 1, the last row tile partial (TMA
//   fills rows past R with zeros, threads that load an operand predicate
//   its rows, and no store lands past R); offsets into the all-actions
//   rows (up to 4,096 x 1,024) are 64-bit.
// * dX: a block owns 16 columns of a 256-row tile (four warpgroups of 64
//   rows): wgmma m64n16k16 with both operands K-major (W' is [N, K']
//   row-major), then the epilogue rounds (and sums the second product),
//   masks by y, writes G and puts float(G) in shared memory (+0.0 past R,
//   as the plain tree pads), and one warp a column runs the bias
//   gradient's tree (rd::column_tree: levels of distance >= 32 in
//   registers, the rest by __shfl_down_sync from the padded half).  Over R
//   > 256 rows (up to 4,096) the grid has a block per tile; each counts
//   its arrival on its column group's counter, and the last to arrive
//   takes the tree's tile levels (tile t + tile t + T/2, elementwise) from
//   G in device memory, then the tree inside a tile (rd::tiled_column_tree):
//   tree_sum_last's order over the padded rows.  The mask's y is loaded
//   before any store of G.
// * The top layers' standalone backward (dense_bwd_kernel): a block owns 8
//   columns of a 256-row tile; two neighbouring threads read a row's 8
//   columns as 16-byte vectors, each thread its two rows (r and r + 128)
//   before any store; the same trees follow.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // k-tile depth, and a 128-byte swizzle row
constexpr int kRowBytes = 128;   // one swizzled row of 64 bf16
constexpr int kDxBN = 16;        // dX: columns a block owns
constexpr int kDxRows = rd::kTileRows;  // backward: rows a block owns (dX:
                                        // 4 warpgroups)
constexpr int kBwdCols = 8;      // standalone backward: columns a block owns
constexpr int kMaxRows = rd::kMaxTiles * rd::kTileRows;  // backward rows

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

// D[64 x 192] += A[64 x 16] * B[16 x 192], both operands in shared memory
// (descriptors); TB: 0 for a K-major B, 1 for an N-major one
template <int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
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
        "+f"(d[95])
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

// ------------------------------------------------------------- forward

// What a forward instance's block reads besides W: a plain x [R, K]; the
// one-hot critic's input rows, which it builds (critic_first_gemm); or a
// plain x with the actor's two heads side by side as W, whose masked
// log-softmax its epilogue takes (actor_heads_gemm).
enum FwdMode { kPlain = 0, kCriticRows = 1, kActorHeads = 2 };

struct FwdArgs {
  const bf16* x;
  const bf16* w;
  const bf16* bias;
  bf16* y;
  float* out32;
  long long ldx, ld32;
  int R, K, N, kt, stages, ring_bytes, relu, x_tma, w_tma, vec32;
  // kCriticRows: x's rows from lat (float32 [B, L]) and the actions (a_dc,
  // a_g int32 [R]; both 0 for every joint action); where x0 is given, the
  // blocks of n-tile 0 also store the rows they build (bf16 [R, K]).  A
  // block stages the lat_rows latent rows its rows use, and its taken
  // actions (at act_off), in the aux_bytes of shared memory behind the
  // ring, the latents by TMA where lat_tma (map_x is then lat's map), and
  // rounds the latents to bf16 once (at lat16_off)
  const float* lat;
  const int* a_dc;
  const int* a_g;
  bf16* x0;
  int B, L, n_dc, n_g, lat_vec, x0_vec, lat_rows, lat_tma, lat16_off, act_off;
  // every joint action with A and L multiples of 64 (no rows kept): a
  // warpgroup's 64 rows share one latent, and its latent k-tiles are
  // atoms of 8 copies at the start of aux (bcast_tile); nothing else of
  // the latents is staged
  int bcast;
  // the bytes behind the ring: the critic's staged latents and actions
  // (its last 8 bytes the latents' mbarrier)
  int aux_bytes;
  // kActorHeads: W's columns [0, n_dc) are w (k_dc [K, n_dc]), the next n_g
  // w2 (k_g [K, n_g]), with biases bias and bias2; per head its mask (bool
  // [R, n]), float32 logits and log-probabilities (float32 [R, n])
  const bf16* w2;
  const bf16* bias2;
  int heads_vec;  // both heads' rows whole 16-byte chunks, 16-byte aligned
  const uint8_t* mask[2];
  float* logits[2];
  float* logp[2];
};

// the layer's output from the product rounded to bf16 (p) and the bias
__device__ __forceinline__ bf16 fwd_out(bf16 p, bf16 b, int relu) {
  bf16 r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(b)));
  if (relu && !(__bfloat162float(r) > 0.0f)) r = __ushort_as_bfloat16(0);
  return r;
}

// The block's sources of its critic rows in shared memory.  Every joint
// action: the latent rows b0 .. b0 + lat_rows - 1 as staged (float32, row
// stride L) and rounded to bf16 once (lat16, the same stride).  The taken
// actions: the block's BM latent rows (b0 = m0) in k-tile boxes (box j,
// columns 64j .. 64j + 63, at lat + 64 BM j, row stride 64), each on its
// own mbarrier and rounded as it is built, and a_dc of the rows followed
// by their a_g.
struct RowsSrc {
  const float* lat;
  const bf16* lat16;
  const int* act;
  int b0;
};

// A thread builds the same 16-byte column (chunk tid % 8) of the same four
// rows (tid / 8 + i BM / 4) of every k-tile: what it needs of each row,
// worked out once.  Row b A + a of every joint action (A = n_dc n_g, a =
// a_dc n_g + a_g), or row b of the taken actions.
struct RowsOfThread {
  const bf16* lat[4];  // every joint action: the row's bf16 latent
  int one[4][2];       // the columns of its ones (-1: an action outside
                       // its head has none)
  bool in[4];          // a row of the layer (< R)
};

// the taken actions' staged latent of tile row r, column j (< L)
template <int BM>
__device__ __forceinline__ const float* taken_lat(const RowsSrc& src, int r,
                                                  int j) {
  return src.lat + (j / kTile) * BM * kTile + r * kTile + j % kTile;
}

template <int BM>
__device__ __forceinline__ RowsOfThread rows_of_thread(const FwdArgs& a,
                                                       const RowsSrc& src,
                                                       int m0) {
  RowsOfThread t;
  const int A = a.n_dc * a.n_g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = threadIdx.x / 8 + i * BM / 4, row = m0 + r;
    int b = row, adc, ag;
    if (a.a_dc == nullptr) {
      b = row / A;
      const int act = row - b * A;
      adc = act / a.n_g;
      ag = act - adc * a.n_g;
    } else {
      adc = src.act[r];
      ag = src.act[BM + r];
    }
    t.lat[i] = src.lat16 + (b - src.b0) * a.L;
    t.one[i][0] = adc >= 0 && adc < a.n_dc ? a.L + adc : -1;
    t.one[i][1] = ag >= 0 && ag < a.n_g ? a.L + a.n_dc + ag : -1;
    t.in[i] = row < a.R;
  }
  return t;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Entries [col0, col0 + 8) of the thread's row i of the one-hot critic's
// input as rl/nets.py::critic_input gives them: bf16(lat[b]) (to nearest
// even, as torch's and XLA's casts) in [0, L), a one at L + a_dc and at
// L + n_dc + a_g (none for an action outside its head), zeros to K and
// past it.  A chunk of latents is a 16-byte copy of the rounded row (the
// taken actions: 8 staged floats rounded), one past them its ones' bits
// (1.0 is 0x3f80 in bf16).
template <int BM>
__device__ __forceinline__ uint4 critic_chunk(const FwdArgs& a,
                                              const RowsSrc& src,
                                              const RowsOfThread& t, int i,
                                              int col0) {
  const int r = threadIdx.x / 8 + i * BM / 4;
  if (!t.in[i] || col0 >= a.K) return make_uint4(0, 0, 0, 0);
  if (a.lat_vec && col0 + 8 <= a.L) {
    if (a.a_dc == nullptr) return *reinterpret_cast<const uint4*>(t.lat[i] + col0);
    const float* f = taken_lat<BM>(src, r, col0);
    const float4 u = *reinterpret_cast<const float4*>(f);
    const float4 v = *reinterpret_cast<const float4*>(f + 4);
    return make_uint4(pack2(u.x, u.y), pack2(u.z, u.w), pack2(v.x, v.y),
                      pack2(v.z, v.w));
  }
  uint32_t w[4] = {0, 0, 0, 0};
  if (col0 >= a.L) {  // word k holds entries 2k, 2k + 1 (no -1 matches)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = t.one[i][h] - col0;
        w[k] |= d == 2 * k ? 0x3f80u : d == 2 * k + 1 ? 0x3f800000u : 0u;
      }
  } else {  // a chunk across L (L not a multiple of 8)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = col0 + k;
      const unsigned short v =
          j >= a.L ? (j == t.one[i][0] || j == t.one[i][1] ? 0x3f80 : 0)
          : a.a_dc == nullptr
              ? __bfloat16_as_ushort(t.lat[i][j])
              : __bfloat16_as_ushort(__float2bfloat16_rn(*taken_lat<BM>(src, r, j)));
      w[k / 2] |= (uint32_t)v << (16 * (k % 2));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16-byte chunk c of row r of a swizzled box (TMA's 128-byte swizzle:
// at r * 128 + (c ^ r % 8) * 16)
__device__ __forceinline__ uint4* swizzled(uint8_t* box, int r, int c) {
  return reinterpret_cast<uint4*>(box + r * kRowBytes + (c ^ (r % 8)) * 16);
}

// Whether k-tile kt of every warpgroup's 64 critic rows is one latent's
// columns repeated 64 times: then 8 copies of it (one 1,024-byte swizzle
// atom, built once at the start, atom (wg, kt) at aux + (wg L / 64 + kt)
// 1024) stand for the 64 rows, which the products read with a stride of
// 0 between 8-row groups
__device__ __forceinline__ bool bcast_tile(const FwdArgs& a, int kt) {
  return a.bcast && kt * kTile < a.L;
}

// Every warpgroup's latent atoms (bcast_tile), by the block's first BM
// threads, a 16-byte chunk of each k-tile a thread: their loads of the
// float32 latent first, then the rounded chunks' stores
template <int BM>
__device__ __forceinline__ void build_atoms(uint8_t* aux, const FwdArgs& a,
                                            int m0) {
  constexpr int kMaxTiles = 4;  // L <= 256 (the host checks)
  const int wg = threadIdx.x / 64, q = threadIdx.x / 8 % 8, c = threadIdx.x % 8;
  const int nt = a.L / kTile, b = (m0 + 64 * wg) / (a.n_dc * a.n_g);
  if (threadIdx.x >= BM) return;
  float4 u[kMaxTiles][2];
#pragma unroll
  for (int kt = 0; kt < kMaxTiles; ++kt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      u[kt][h] = kt < nt && b < a.B
                     ? *reinterpret_cast<const float4*>(
                           a.lat + (long long)b * a.L + kt * kTile + 8 * c + 4 * h)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int kt = 0; kt < kMaxTiles; ++kt)
    if (kt < nt)
      *swizzled(aux + (wg * nt + kt) * 1024, q, c) =
          make_uint4(pack2(u[kt][0].x, u[kt][0].y), pack2(u[kt][0].z, u[kt][0].w),
                     pack2(u[kt][1].x, u[kt][1].y), pack2(u[kt][1].z, u[kt][1].w));
}

// k-tile kt of the block's BM critic rows into shared memory, swizzled as
// TMA lays a box out, from the staged sources, by every thread of the
// block (2 BM of them): its four 16-byte chunks (RowsOfThread); nothing for
// a bcast_tile (its atoms are built).  The blocks of n-tile 0 also store
// the rows into x0 where it is given.
template <int BM>
__device__ __forceinline__ void build_rows(uint8_t* dst, const FwdArgs& a,
                                           const RowsSrc& src,
                                           const RowsOfThread& t,
                                           uint64_t* lat_bars, int m0,
                                           int kt) {
  if (bcast_tile(a, kt)) return;
  if (a.a_dc != nullptr && a.lat_tma && kt * kTile < a.L)
    mbar_wait(lat_bars + kt, 0);  // the taken actions' latent box kt
  const int c = threadIdx.x % 8, col0 = kt * kTile + 8 * c;
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = critic_chunk<BM>(a, src, t, i, col0);
  const bool side = a.x0 != nullptr && blockIdx.y == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = threadIdx.x / 8 + i * BM / 4, row = m0 + r;
    *swizzled(dst, r, c) = v[i];
    if (side && row < a.R && col0 < a.K) {
      bf16* o = a.x0 + (long long)row * a.K + col0;
      if (a.x0_vec) {
        *reinterpret_cast<uint4*>(o) = v[i];
      } else {
        const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (col0 + k < a.K)
            o[k] = __ushort_as_bfloat16((unsigned short)(w[k / 2] >> (16 * (k % 2))));
      }
    }
  }
}

// Chunk c (columns 8c .. 8c + 7) of k row k of the actor's two heads'
// kernels side by side: k_dc in columns [0, n_dc), k_g in the next n_g,
// zeros past them and past K
__device__ __forceinline__ uint4 heads_chunk(const FwdArgs& a, int k, int c) {
  const int n = a.n_dc + a.n_g;
  if (k >= a.K) return make_uint4(0, 0, 0, 0);
  if (a.heads_vec)  // both heads 8-column multiples: a chunk is one head's
    return 8 * c < a.n_dc
               ? *reinterpret_cast<const uint4*>(a.w + (long long)k * a.n_dc + 8 * c)
               : *reinterpret_cast<const uint4*>(a.w2 + (long long)k * a.n_g +
                                                 8 * c - a.n_dc);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * c + i;
    bf16 v = __ushort_as_bfloat16(0);
    if (col < a.n_dc)
      v = a.w[(long long)k * a.n_dc + col];
    else if (col < n)
      v = a.w2[(long long)k * a.n_g + col - a.n_dc];
    w[i / 2] |= (uint32_t)__bfloat16_as_ushort(v) << (16 * (i % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The whole K of the heads' kernels into W's half of every stage (N-major
// and swizzled as TMA lays out a [K, N] kernel's BN / 64 boxes), by every
// thread of the block, two k rows a thread at a time, a box (8 chunks of 8
// columns) at a time: the loads of its chunks that hold entries first, then
// all its chunks (zeros past the heads)
template <int BM, int BN>
__device__ __forceinline__ void load_heads(uint8_t* smem, const FwdArgs& a) {
  constexpr int A_BYTES = BM * kRowBytes, STAGE = (BM + BN) * kRowBytes;
  const int nc = (a.n_dc + a.n_g + 7) / 8, rows = a.kt * kTile;
  const int T = blockDim.x;
  for (int k0 = threadIdx.x; k0 < rows; k0 += 2 * T) {
#pragma unroll
    for (int box = 0; box < BN / 64; ++box) {
      uint4 v[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[i][c] = 8 * box + c < nc && k0 + i * T < rows
                        ? heads_chunk(a, k0 + i * T, 8 * box + c)
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + i * T;
        if (k < rows)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            *swizzled(smem + (k / kTile) * STAGE + A_BYTES + box * 64 * kRowBytes,
                      k % kTile, c) = v[i][c];
      }
    }
  }
}

// A latent row b of the critic's source, or zeros past B (the staging's
// thread path, where TMA cannot describe lat)
__device__ __forceinline__ float lat_at(const FwdArgs& a, int b, int j) {
  return b < a.B ? a.lat[(long long)b * a.L + j] : 0.0f;
}

// What the block's threads stage in shared memory before the product
// loop: the critic's taken actions (and its latent rows where TMA cannot
// load them, a thread's loads eight together, then their stores).
template <int BM>
__device__ __forceinline__ void stage_rows(const FwdArgs& a,
                                           const RowsSrc& src, int m0) {
  const int T = blockDim.x;
  {
    int* act = const_cast<int*>(src.act);
    if (a.a_dc != nullptr)
      for (int r = threadIdx.x; r < BM; r += T) {
        const bool in = m0 + r < a.R;
        act[r] = in ? a.a_dc[m0 + r] : 0;
        act[BM + r] = in ? a.a_g[m0 + r] : 0;
      }
    if (!a.lat_tma && a.lat_rows > 0) {  // element e of the staged layout (RowsSrc)
      float* lat = const_cast<float*>(src.lat);
      const bool taken = a.a_dc != nullptr;
      const int n = taken ? (a.L + kTile - 1) / kTile * kTile * BM : a.lat_rows * a.L;
      for (int base = 0; base < n; base += 8 * T) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = base + threadIdx.x + i * T;
          const int row = taken ? e / kTile % BM : e / a.L;
          const int col = taken ? e / (kTile * BM) * kTile + e % kTile : e % a.L;
          v[i] = e < n && col < a.L ? lat_at(a, src.b0 + row, col) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = base + threadIdx.x + i * T;
          if (e < n) lat[e] = v[i];
        }
      }
    }
  }
}

// thread 0: the block's latent rows by TMA into shared memory (zeros past
// B and L), as RowsSrc lays them out: every joint action one box of
// lat_rows x L floats on bars[0]; the taken actions a box of BM x 64 a
// k-tile, box j on bars[j]
template <int BM>
__device__ __forceinline__ void lat_issue(float* dst, const CUtensorMap* map,
                                          uint64_t* bars, const FwdArgs& a,
                                          int b0) {
  if (a.a_dc == nullptr) {
    mbar_arrive_tx(bars, (uint32_t)(a.lat_rows * a.L * 4));
    tma_load(dst, map, bars, 0, b0);
    return;
  }
  for (int j = 0; j * kTile < a.L; ++j) {
    mbar_arrive_tx(bars + j, (uint32_t)(BM * kTile * 4));
    tma_load(dst + j * BM * kTile, map, bars + j, j * kTile, b0);
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival a warp, after all its lanes' stores and proxy fences
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// thread 0: arm stage kt % stages and issue k-tile kt's TMA loads of the
// operands TMA loads (x_tma, w_tma)
template <int BM, int BN>
__device__ __forceinline__ void fwd_issue(uint8_t* smem, uint64_t* full,
                                          const CUtensorMap* mx,
                                          const CUtensorMap* mw, bool x_tma,
                                          bool w_tma, int stages, int kt,
                                          int m0, int n0) {
  constexpr int A_BYTES = BM * kRowBytes, STAGE = (BM + BN) * kRowBytes;
  const int s = kt % stages;
  uint8_t* st = smem + s * STAGE;
  const uint32_t tx = (x_tma ? A_BYTES : 0) + (w_tma ? BN * kRowBytes : 0);
  mbar_arrive_tx(&full[s], tx);
  if (x_tma) tma_load(st, mx, &full[s], kt * kTile, m0);
  if (w_tma)
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
__device__ __forceinline__ void fwd_mma<192>(float (&acc)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_n192<1>(acc, da, db, scale_d);
}
template <>
__device__ __forceinline__ void fwd_mma<256>(float (&acc)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_n256<1>(acc, da, db, scale_d);
}

constexpr float kNegMask = -1e9f;

// The actor heads' epilogue (kActorHeads), from the block's [BM x BN] tile
// of bf16 products (row stride TS): each logit the product plus its head's
// bf16 bias (fwd_out, no ReLU), written as float32 per head and kept in
// the tile; then one thread per (row, head) takes the masked log-softmax
// (its mask's line prefetched before the product loop) of
// rl/nets.py::masked_log_softmax op for op (x = mask ? l : -1e9, torch's
// max with NaN winning, expf(x - m) summed by the halving tree zero-padded
// to a power of two, (x - m) - logf(S)).  The tree takes its leaves as it
// needs them (rd::tree_regs: depth first up to 16, streamed above, at most
// 9 partial sums live), so a head of up to 256 entries needs no scratch.
template <int BM, int TS>
__device__ __forceinline__ void heads_epilogue(bf16* tile, const bf16* bias_s,
                                               const FwdArgs& a, int m0) {
  const int tid = threadIdx.x, n = a.n_dc + a.n_g;
  for (int e = tid; e < BM * n; e += blockDim.x) {
    const int r = e / n, c = e % n, row = m0 + r;
    const bf16 y = fwd_out(tile[r * TS + c], bias_s[c], 0);
    tile[r * TS + c] = y;
    if (row >= a.R) continue;
    if (c < a.n_dc)
      a.logits[0][(long long)row * a.n_dc + c] = __bfloat162float(y);
    else
      a.logits[1][(long long)row * a.n_g + c - a.n_dc] = __bfloat162float(y);
  }
  __syncthreads();
  const int h = tid / BM, r = tid % BM, row = m0 + r;  // a warp, one head
  if (row >= a.R) return;
  const int nh = h ? a.n_g : a.n_dc;
  const uint8_t* mk = a.mask[h] + (long long)row * nh;
  const bf16* l = tile + r * TS + (h ? a.n_dc : 0);
  auto x_at = [&](int j) { return mk[j] ? __bfloat162float(l[j]) : kNegMask; };
  // the max by torch's rule (NaN wins)
  float m = 0.0f;
#pragma unroll 8
  for (int j = 0; j < nh; ++j) {
    const float x = x_at(j);
    if (j == 0 || x != x || (m == m && x > m)) m = x;
  }
  const float S = rd::tree_regs(rd::pow2_at_least(nh), 0.0f, [&](int j) {
    return j < nh ? expf(x_at(j) - m) : 0.0f;
  });
  const float lse = logf(S);
  float* out = a.logp[h] + (long long)row * nh;
#pragma unroll 8
  for (int j = 0; j < nh; ++j) out[j] = (x_at(j) - m) - lse;
}

// The forward layer of one [BM x BN] tile (the design in the head note).
template <int WG, int BN, int MODE>
__device__ __forceinline__ void fwd_body(const CUtensorMap* map_x,
                                         const CUtensorMap* map_w,
                                         const FwdArgs& a) {
  constexpr int BM = 64 * WG;
  constexpr int A_BYTES = BM * kRowBytes, STAGE = (BM + BN) * kRowBytes;
  constexpr bool kRows = MODE == kCriticRows, kHeads = MODE == kActorHeads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // the ring (which the epilogue's tile reuses), what the block stages
  // behind it (aux), the ring's mbarriers, the bias
  uint8_t* aux = smem + a.ring_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(aux + a.aux_bytes);
  bf16* bias_s = reinterpret_cast<bf16*>(  // 16-byte aligned
      aux + a.aux_bytes + ((a.stages * 8 + 15) & ~15));
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // the critic's rows come from its latent rows b0 .. and taken actions,
  // staged in aux (the latents' mbarriers in its last 32 bytes)
  const RowsSrc src{reinterpret_cast<const float*>(aux),
                    reinterpret_cast<const bf16*>(aux + a.lat16_off),
                    reinterpret_cast<const int*>(aux + a.act_off),
                    a.a_dc != nullptr ? m0 : m0 / (a.n_dc * a.n_g)};
  uint64_t* lat_bars = reinterpret_cast<uint64_t*>(aux + a.aux_bytes - 32);
  // what the block's threads put in the ring themselves: the critic's rows
  // (built), the heads' kernels, an operand TMA cannot describe
  const bool x_tma = !kRows && a.x_tma, w_tma = !kHeads && a.w_tma;
  const bool tma = x_tma || w_tma;
  // thread 0 sets up the ring and puts its loads in flight at once; the
  // block stages the bias meanwhile (nobody waits on the ring before the
  // barrier below).  The critic's rows are built stage by stage: every
  // warp arrives on the stage's barrier after its part, beside thread 0's
  // arrival with W's bytes where TMA loads W.
  if (tid == 0) {
    if (x_tma) prefetch_map(map_x);
    if (w_tma) prefetch_map(map_w);
    for (int s = 0; s < a.stages; ++s)
      mbar_init(&full[s], kRows ? blockDim.x / 32 + (w_tma ? 1 : 0) : 1);
    if (kRows && a.lat_tma)
      for (int j = 0; j < 4; ++j) mbar_init(lat_bars + j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (kRows && a.lat_tma)
      lat_issue<BM>(const_cast<float*>(src.lat), map_x, lat_bars, a, src.b0);
    if (tma)
      for (int kt = 0; kt < a.kt && kt < a.stages; ++kt)
        fwd_issue<BM, BN>(smem, full, map_x, map_w, x_tma, w_tma, a.stages, kt,
                          m0, n0);
  }
  for (int c = tid; c < BN; c += blockDim.x) {
    bf16 b = __ushort_as_bfloat16(0);
    if (kHeads) {
      if (c < a.n_dc)
        b = a.bias[c];
      else if (c < a.n_dc + a.n_g)
        b = a.bias2[c - a.n_dc];
    } else if (n0 + c < a.N) {
      b = a.bias[n0 + c];
    }
    bias_s[c] = b;
  }
  if (kRows) stage_rows<BM>(a, src, m0);
  if (kHeads) {  // the mask row the thread's log-softmax reads, into L1
    const int h = tid / BM, row = m0 + tid % BM, nh = h ? a.n_g : a.n_dc;
    if (row < a.R)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(a.mask[h] + (long long)row * nh));
  }
  RowsOfThread rows{};
  if (kRows) {
    // the actions staged (and the latents where the threads stage them);
    // every joint action's latent rows rounded to bf16 once
    __syncthreads();
    bf16* lat16 = const_cast<bf16*>(src.lat16);
    const int n = a.a_dc == nullptr ? a.lat_rows * a.L : 0;
    if (n > 0 && a.lat_tma) mbar_wait(lat_bars, 0);
    for (int e = 8 * tid; e < n; e += 8 * blockDim.x) {
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = e + k < n ? src.lat[e + k] : 0.0f;
      const uint4 v = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                                 pack2(f[4], f[5]), pack2(f[6], f[7]));
      if (e + 8 <= n) {
        *reinterpret_cast<uint4*>(lat16 + e) = v;
      } else {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (e + k < n)
            lat16[e + k] = __ushort_as_bfloat16((unsigned short)(w[k / 2] >> (16 * (k % 2))));
      }
    }
    __syncthreads();
    rows = rows_of_thread<BM>(a, src, m0);
  }
  if (kRows && a.bcast) build_atoms<BM>(aux, a, m0);
  // what the threads load into the ring (the whole K: the plan checks),
  // and the critic's atoms, fenced for the products
  if (!x_tma || !w_tma) {
    if (kHeads) load_heads<BM, BN>(smem, a);
    for (int kt = 0; kt < a.kt; ++kt) {
      uint8_t* st = smem + kt * STAGE;
      if (!kRows && !x_tma)
        load_box(st, a.x, a.ldx, a.R, a.K, m0, kt * kTile, BM);
      if (!kHeads && !w_tma)
        for (int j = 0; j < BN / 64; ++j)
          load_box(st + A_BYTES + j * 64 * kRowBytes, a.w, a.N, a.K, a.N,
                   kt * kTile, n0 + 64 * j, kTile);
    }
    fence_generic_to_async();
  }
  __syncthreads();
  if (kRows) {  // k-tile 0's rows (the barriers are initialized now)
    build_rows<BM>(smem, a, src, rows, lat_bars, m0, 0);
    fence_generic_to_async();
    warp_arrive(&full[0]);
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < a.kt; ++kt) {
    const int s = kt % a.stages;
    if (tma || kRows) mbar_wait(&full[s], (kt / a.stages) & 1);
    // x: K-major, this warpgroup's 64 rows; a k16 step is 32 bytes along a
    // swizzled row.  W: N-major, 64-column chunks 64 rows apart (LBO), eight
    // k rows a 1,024-byte swizzle atom (SBO); a k16 step is 16 rows.
    const bool atom = kRows && bcast_tile(a, kt);
    const uint32_t sa =
        atom ? smem_u32(aux + (wg * (a.L / kTile) + kt) * 1024)
             : smem_u32(smem + s * STAGE) + wg * 64 * kRowBytes;
    const uint32_t sb = smem_u32(smem + s * STAGE + A_BYTES);
    const uint32_t sbo = atom ? 0 : 1024;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks)
      fwd_mma<BN>(acc, desc(sa + ks * 32, 16, sbo),
                  desc(sb + ks * 16 * kRowBytes, 64 * kRowBytes, 1024),
                  (kt | ks) != 0);
    wgmma_commit();
    fence_regs(acc);
    if (kRows) {
      // the rows are built with no product in flight (code between a
      // product and its wait makes ptxas serialize every product): this
      // k-tile's retired first, then the next stage not yet filled, then
      // this stage refilled
      wgmma_wait_all();
      fence_regs(acc);
      if (kt + 1 < a.stages && kt + 1 < a.kt) {
        build_rows<BM>(smem + (kt + 1) * STAGE, a, src, rows, lat_bars, m0, kt + 1);
        fence_generic_to_async();
        warp_arrive(&full[kt + 1]);
      }
      if (kt + a.stages < a.kt) {
        __syncthreads();  // every warpgroup's products on this stage done
        if (tid == 0 && w_tma)
          fwd_issue<BM, BN>(smem, full, map_x, map_w, false, true, a.stages,
                            kt + a.stages, m0, n0);
        build_rows<BM>(smem + s * STAGE, a, src, rows, lat_bars, m0, kt + a.stages);
        fence_generic_to_async();
        warp_arrive(&full[s]);
      }
    } else if (kt + a.stages < a.kt) {  // refill this stage: every product on it done
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();
      if (tid == 0)
        fwd_issue<BM, BN>(smem, full, map_x, map_w, x_tma, w_tma, a.stages,
                          kt + a.stages, m0, n0);
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // epilogue.  Thread (warp w, lane l) of a warpgroup holds rows 16w + l/4
  // (+8) and columns 8n + 2(l % 4) (+1) of the product: rounded to bf16,
  // they go to a [BM x BN] tile in shared memory (the ring is free now;
  // rows padded by 16 bytes, so the pairs of a warp hit distinct banks),
  // then the block adds the bias, applies the ReLU and stores whole rows
  // in 16-byte pieces (the heads: their log-softmax, heads_epilogue).
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
  if (kHeads) {
    heads_epilogue<BM, TS>(tile, bias_s, a, m0);
    return;
  }
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

// Three instances of the body, named apart for the profiler: a plain
// layer, the one-hot critic's first layer, the actor's two heads.
template <int WG, int BN>
__global__ void __launch_bounds__(WG * 128, BN <= 128 ? 2 : 1)
    dense_fwd_gemm(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  fwd_body<WG, BN, kPlain>(&map_x, &map_w, a);
}

template <int WG, int BN>
__global__ void __launch_bounds__(WG * 128, BN <= 128 ? 2 : 1)
    critic_first_gemm(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  fwd_body<WG, BN, kCriticRows>(&map_x, &map_w, a);
}

template <int WG, int BN>
__global__ void __launch_bounds__(WG * 128, 1)
    actor_heads_gemm(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  fwd_body<WG, BN, kActorHeads>(&map_x, &map_w, a);
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
  unsigned* counters;  // one a column group, 0 at the launch (R > 256)
  int R, N, P, stages, n_kt;
};

__device__ __forceinline__ uint32_t dx_tx(const DxArgs& a, int p) {
  return (a.g_tma[p] ? kDxRows * kRowBytes : 0) +
         (a.w_tma[p] ? kDxBN * kRowBytes : 0);
}

// thread 0: arm stage t % stages and issue tile t's TMA loads (tile t is
// k-tile t of the first product, then those of the second) for the
// block's rows m0 .. m0 + 255 (TMA fills rows past R with zeros)
__device__ __forceinline__ void dx_issue(uint8_t* smem, uint64_t* full,
                                         const CUtensorMap* mg,
                                         const CUtensorMap* mw,
                                         const DxArgs& a, int t, int m0,
                                         int n0) {
  constexpr int A_BYTES = kDxRows * kRowBytes;
  constexpr int STAGE = (kDxRows + kDxBN) * kRowBytes;
  const int p = t < a.kt[0] ? 0 : 1, kk = p ? t - a.kt[0] : t;
  const int s = t % a.stages;
  uint8_t* st = smem + s * STAGE;
  mbar_arrive_tx(&full[s], dx_tx(a, p));
  if (a.g_tma[p]) tma_load(st, mg + p, &full[s], kk * kTile, m0);
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
  const int n0 = blockIdx.x * kDxBN, m0 = blockIdx.y * kDxRows;
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
        dx_issue(smem, full, maps.g, maps.w, a, t, m0, n0);
  }
  const int w = (tid % 128) / 32, l = tid % 32;
  const int row_a = wg * 64 + w * 16 + l / 4;
  constexpr int NV = kDxBN / 2;
  float yv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int row = m0 + row_a + 8 * ((i / 2) % 2);
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
        load_box(st, a.g[p], a.ldg[p], a.R, a.kc[p], m0, kk * kTile, kDxRows);
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
      if (tid == 0) dx_issue(smem, full, maps.g, maps.w, a, t + a.stages, m0, n0);
    }
  }
  wgmma_wait_all();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // epilogue: round (and sum the second product), mask, write G and the
  // tree's rows (+0.0 past R and N, as the plain tree pads)
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int r = row_a + 8 * ((i / 2) % 2), row = m0 + r;
    const int cl = 8 * (i / 4) + 2 * (l % 4) + i % 2, col = n0 + cl;
    bf16 v = __float2bfloat16_rn(acc[0][i]);
    if (NP == 2)
      v = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(v), __bfloat162float(__float2bfloat16_rn(acc[1][i]))));
    const bool in = row < a.R && col < a.N;
    if (!(yv[i] > 0.0f)) v = __ushort_as_bfloat16(0);
    if (in) a.G[(long long)row * a.N + col] = v;
    tree[r * TS + cl] = in ? __bfloat162float(v) : 0.0f;
  }
  // the bias gradient: over one tile, the block's tree from shared memory;
  // over several, the last of the column group's blocks to finish takes
  // the tiles' levels from G, then the tree inside a tile
  const int c = tid / 32;  // one warp a column (16 warps, 16 columns)
  float sum;
  if (gridDim.y == 1) {
    __syncthreads();
    sum = rd::column_tree(tree, TS, c, a.P);
  } else {
    if (!rd::block_arrives_last(a.counters + blockIdx.x, gridDim.y,
                                reinterpret_cast<int*>(tree)))
      return;
    sum = rd::tiled_column_tree<kDxBN>(a.G, a.N, a.R, a.N, n0, tree);
  }
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
                     bf16* __restrict__ G, bf16* __restrict__ db,
                     unsigned* counters, int R, int N, int P, int vec) {
  constexpr int TS = kBwdCols + 1;
  constexpr int kHalf = kDxRows / 2;
  __shared__ float s[kDxRows * TS];
  const int c0 = blockIdx.x * kBwdCols, m0 = blockIdx.y * kDxRows;
  const int q = threadIdx.x % 2, col = c0 + 4 * q;  // 4 columns a thread
  const int two = g2 != nullptr;
  // rows r and r + 128 of this thread's tile: every input loaded before any
  // store
  float gv[2][4], g2v[2][4], yv[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + threadIdx.x / 2 + h * kHalf;
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
    const int t = threadIdx.x / 2 + h * kHalf, r = m0 + t;
    const long long ri = (long long)r * N + col;
    bf16 out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = r < R && col + e < N;
      out[e] = in ? grad_of(gv[h][e], g_f32, two, g2v[h][e], yv[h][e])
                  : __ushort_as_bfloat16(0);
      s[t * TS + 4 * q + e] = __bfloat162float(out[e]);
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
  // the bias gradient, as dense_dx_gemm's
  const int c = threadIdx.x / 32;  // one warp a column
  float sum;
  if (gridDim.y == 1) {
    __syncthreads();
    sum = rd::column_tree(s, TS, c, P);
  } else {
    if (!rd::block_arrives_last(counters + blockIdx.x, gridDim.y,
                                reinterpret_cast<int*>(s)))
      return;
    sum = rd::tiled_column_tree<kBwdCols>(G, N, R, N, c0, s);
  }
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

// a 2-D map of a row-major contiguous float32 matrix (rows x cols) in boxes
// of box_rows x box_cols, unswizzled; zeros outside it
int make_rows_map(CUtensorMap* m, const void* base, long long rows, int cols,
                  int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
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
  const int ring = stages * (bm + bn) * kRowBytes;
  const int tile = bm * (bn + 8) * 2;
  return ring > tile ? ring : tile;
}

int fwd_smem(int bm, int bn, int stages, int aux = 0) {
  return 1024 + fwd_ring(bm, bn, stages) + aux + stages * 8 + 16 + bn * 2;
}

// The critic's staging behind the ring (RowsSrc): the latent rows a
// block's BM rows use (every joint action: at most (BM - 1) / A + 2 of
// them, as float32 and rounded to bf16, or where bcast the warpgroups'
// latent atoms; the taken actions: BM, float32 in k-tile boxes), its
// taken actions, the latents' four mbarriers; sets lat_rows, lat16_off,
// act_off, aux_bytes
void critic_aux(FwdArgs& a, int bm) {
  const bool taken = a.a_dc != nullptr;
  const int A = a.n_dc * a.n_g;
  a.lat_rows = a.bcast ? 0 : taken ? bm : (bm - 1) / A + 2;
  if (a.lat_rows > bm) a.lat_rows = bm;
  const int lat32 = a.bcast ? bm / 64 * (a.L / kTile) * 1024
                    : taken ? (a.L + kTile - 1) / kTile * kTile * bm * 4
                            : a.lat_rows * a.L * 4;
  a.lat16_off = (lat32 + 15) & ~15;
  a.act_off = a.lat16_off + (taken ? 0 : (a.lat_rows * a.L * 2 + 15) & ~15);
  a.aux_bytes = (a.act_off + 2 * bm * 4 + 32 + 127) & ~127;
}

int dx_smem(int stages) {
  return 1024 + stages * (kDxRows + kDxBN) * kRowBytes +
         kDxRows * (kDxBN + 1) * 4 + stages * 8;
}

// the forward instance of a mode (only that one is instantiated)
template <int WG, int BN, int MODE>
constexpr auto fwd_kernel() {
  if constexpr (MODE == kCriticRows)
    return critic_first_gemm<WG, BN>;
  else if constexpr (MODE == kActorHeads)
    return actor_heads_gemm<WG, BN>;
  else
    return dense_fwd_gemm<WG, BN>;
}

template <int WG, int BN, int MODE>
int fwd_launch(const CUtensorMap& mx, const CUtensorMap& mw, const FwdArgs& a,
               cudaStream_t stream) {
  static bool attr = false;
  auto kern = fwd_kernel<WG, BN, MODE>();
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((a.R + 64 * WG - 1) / (64 * WG), (a.N + BN - 1) / BN);
  const int smem = fwd_smem(64 * WG, BN, a.stages, a.aux_bytes);
  kern<<<grid, WG * 128, smem, stream>>>(mx, mw, a);
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
  const dim3 grid((a.N + kDxBN - 1) / kDxBN, (a.R + kDxRows - 1) / kDxRows);
  dense_dx_gemm<NP><<<grid, 512, dx_smem(a.stages), stream>>>(maps, a);
  return (int)cudaGetLastError();
}

bool rows_ok(long long R) { return R >= 1 && R <= (1LL << 30); }

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns its launch's
// cudaError_t, -1 for a shape or plan the kernel does not take, -2 when
// libcuda's tensor-map encoder is missing, -3 when it refuses an operand.
//
// Forward: x (bf16 [R, K], row stride ldx, unit column stride), w (bf16
// [K, N] contiguous), bias (bf16 [N]); writes y (bf16 [R, N] contiguous)
// and, where out32 is not 0, its float32 copy (row stride ld32, unit
// column stride).  Any R >= 1: the last row tile is partial (TMA fills its
// rows past R with zeros, the epilogue stores none of them).  bm in {64,
// 128}, bn in {64, 128, 256} and the ring's stages come from the wrapper's
// plan (kernels/dense.py::fwd_plan).
extern "C" int dense_fwd_launch(const void* x, long long ldx, const void* w,
                                const void* bias, void* y, void* out32,
                                long long ld32, int R, int K, int N, int relu,
                                int bm, int bn, int stages, void* stream) {
  if (!rows_ok(R) || K < 1 || N < 1 || ldx < K || stages < 1 ||
      fwd_smem(bm, bn, stages) > kSmemMax)
    return -1;
  FwdArgs a = {};
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
  if (bm == 64 && bn == 64) return fwd_launch<1, 64, kPlain>(mx, mw, a, s);
  if (bm == 128 && bn == 64) return fwd_launch<2, 64, kPlain>(mx, mw, a, s);
  if (bm == 128 && bn == 256) return fwd_launch<2, 256, kPlain>(mx, mw, a, s);
  if (bm == 64 && bn == 256) return fwd_launch<1, 256, kPlain>(mx, mw, a, s);
  if (bm == 128 && bn == 128) return fwd_launch<2, 128, kPlain>(mx, mw, a, s);
  if (bm == 64 && bn == 128) return fwd_launch<1, 128, kPlain>(mx, mw, a, s);
  return -1;
}

// The one-hot critic's first layer: y = ReLU(x0 w + bias) (bf16 [R, N]
// contiguous) with x0 the critic's input rows, built in shared memory from
// lat (float32 [B, L] contiguous) and the actions: a_dc, a_g (int32 [B])
// for the taken actions (R = B), or both 0 for every joint action (R = B
// n_dc n_g); w (bf16 [L + n_dc + n_g, N] contiguous), bias (bf16 [N]);
// where x0 is not 0 it also receives the rows (bf16 [R, L + n_dc + n_g]
// contiguous).  bm, bn, stages from kernels/dense.py::critic_plan; a ring
// shallower than K needs w through TMA.  Latents TMA cannot load (L not a
// multiple of 4 or above 256) are staged by the block's threads.
extern "C" int critic_first_launch(const void* lat, const void* a_dc,
                                   const void* a_g, void* x0, int B, int L,
                                   int n_dc, int n_g, const void* w,
                                   const void* bias, void* y, int N, int bm,
                                   int bn, int stages, void* stream) {
  if (B < 1 || L < 1 || n_dc < 1 || n_g < 1 || N < 1 ||
      (a_dc == nullptr) != (a_g == nullptr) || stages < 1)
    return -1;
  const long long R = a_dc == nullptr ? (long long)B * n_dc * n_g : B;
  if (!rows_ok(R)) return -1;
  FwdArgs a = {};
  a.w = reinterpret_cast<const bf16*>(w);
  a.bias = reinterpret_cast<const bf16*>(bias);
  a.y = reinterpret_cast<bf16*>(y);
  a.R = (int)R, a.K = L + n_dc + n_g, a.N = N, a.relu = 1, a.stages = stages;
  a.ldx = a.K;
  a.ring_bytes = fwd_ring(bm, bn, stages);
  a.kt = (a.K + kTile - 1) / kTile;
  a.w_tma = tma_ok(w, N);
  a.lat = reinterpret_cast<const float*>(lat);
  a.a_dc = reinterpret_cast<const int*>(a_dc);
  a.a_g = reinterpret_cast<const int*>(a_g);
  a.x0 = reinterpret_cast<bf16*>(x0);
  a.B = B, a.L = L, a.n_dc = n_dc, a.n_g = n_g;
  a.lat_vec = L % 8 == 0;

  a.x0_vec = a.K % 8 == 0 && reinterpret_cast<uintptr_t>(x0) % 16 == 0;
  a.bcast = a_dc == nullptr && x0 == nullptr && (n_dc * n_g) % 64 == 0 &&
            L % kTile == 0 && L <= 256 && reinterpret_cast<uintptr_t>(lat) % 16 == 0;
  critic_aux(a, bm);
  a.lat_tma = !a.bcast && L % 4 == 0 && L <= 256 &&
              reinterpret_cast<uintptr_t>(lat) % 16 == 0;
  if ((!a.w_tma && a.kt > stages) ||
      fwd_smem(bm, bn, stages, a.aux_bytes) > kSmemMax)
    return -1;
  CUtensorMap mx = {}, mw = {};
  int rc;
  if (a.lat_tma &&
      (rc = make_rows_map(&mx, lat, B, L, a.lat_rows, a_dc == nullptr ? L : kTile)) != 0)
    return rc;
  if (a.w_tma && (rc = make_map(&mw, w, a.K, N, N, kTile)) != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return fwd_launch<1, 64, kCriticRows>(mx, mw, a, s);
  if (bm == 128 && bn == 64) return fwd_launch<2, 64, kCriticRows>(mx, mw, a, s);
  if (bm == 128 && bn == 128) return fwd_launch<2, 128, kCriticRows>(mx, mw, a, s);
  if (bm == 64 && bn == 128) return fwd_launch<1, 128, kCriticRows>(mx, mw, a, s);
  if (bm == 128 && bn == 256) return fwd_launch<2, 256, kCriticRows>(mx, mw, a, s);
  return -1;
}

// The actor's two heads in one launch: the logits l_dc = x w_dc + b_dc and
// l_g = x w_g + b_g (each product rounded to bf16, its bias added in
// float32 and rounded, written as float32 [R, n] contiguous) and their
// masked log-softmax lp_dc, lp_g (float32 [R, n] contiguous) under the
// masks m_dc, m_g (bool [R, n] contiguous); x bf16 [R, K] (row stride ldx,
// unit column stride), w_dc bf16 [K, n_dc] and w_g bf16 [K, n_g]
// contiguous, b_dc, b_g bf16.  n_dc + n_g <= bn, one tile of bn in {64,
// 128, 192, 256} columns; the whole K in the ring (bm, bn and stages from
// kernels/dense.py::heads_plan).
extern "C" int actor_heads_launch(const void* x, long long ldx, const void* w_dc,
                                  const void* b_dc, const void* w_g,
                                  const void* b_g, const void* m_dc,
                                  const void* m_g, void* l_dc, void* l_g,
                                  void* lp_dc, void* lp_g, int R, int K,
                                  int n_dc, int n_g, int bm, int bn, int stages,
                                  void* stream) {
  if (!rows_ok(R) || K < 1 || n_dc < 1 || n_g < 1 || n_dc + n_g > bn ||
      bm != 64 || ldx < K || stages < 1 || fwd_smem(bm, bn, stages) > kSmemMax)
    return -1;
  FwdArgs a = {};
  a.x = reinterpret_cast<const bf16*>(x);
  a.w = reinterpret_cast<const bf16*>(w_dc);
  a.w2 = reinterpret_cast<const bf16*>(w_g);
  a.bias = reinterpret_cast<const bf16*>(b_dc);
  a.bias2 = reinterpret_cast<const bf16*>(b_g);
  a.ldx = ldx;
  a.R = R, a.K = K, a.N = n_dc + n_g, a.stages = stages;
  a.n_dc = n_dc, a.n_g = n_g;
  a.ring_bytes = fwd_ring(bm, bn, stages);
  a.kt = (K + kTile - 1) / kTile;
  a.x_tma = tma_ok(x, ldx);
  a.heads_vec = n_dc % 8 == 0 && n_g % 8 == 0 &&
                reinterpret_cast<uintptr_t>(w_dc) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(w_g) % 16 == 0;
  a.mask[0] = reinterpret_cast<const uint8_t*>(m_dc);
  a.mask[1] = reinterpret_cast<const uint8_t*>(m_g);
  a.logits[0] = reinterpret_cast<float*>(l_dc);
  a.logits[1] = reinterpret_cast<float*>(l_g);
  a.logp[0] = reinterpret_cast<float*>(lp_dc);
  a.logp[1] = reinterpret_cast<float*>(lp_g);
  if (a.kt > stages) return -1;
  CUtensorMap mx = {}, mw = {};
  int rc;
  if (a.x_tma && (rc = make_map(&mx, x, R, K, ldx, bm)) != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return fwd_launch<1, 64, kActorHeads>(mx, mw, a, s);
    case 128: return fwd_launch<1, 128, kActorHeads>(mx, mw, a, s);
    case 192: return fwd_launch<1, 192, kActorHeads>(mx, mw, a, s);
    case 256: return fwd_launch<1, 256, kActorHeads>(mx, mw, a, s);
  }
  return -1;
}

// dX: G = mask(bf16(g w^T)) (or the rounded sum of two such products, g2
// and w2 given), writes G (bf16 [R, N] contiguous) and db (bf16 [N]), the
// tree over its rows.  g (bf16 [R, kc], row stride ldg), w (bf16 [N, kc],
// row stride ldw: the layer above's kernel), likewise g2 and w2 (kc2 deep)
// or 0; y (bf16 [R, N] contiguous) the layer's output, or 0 for no mask.
// 1 <= R <= 4,096, a block a 256-row tile of 16 columns; over several
// tiles `counters` (zeroed uint32, one a column group) count the tiles
// done.  The ring's stages come from kernels/dense.py::dx_plan.
extern "C" int dense_dx_launch(const void* g, long long ldg, const void* w,
                               long long ldw, int kc, const void* g2,
                               long long ldg2, const void* w2, long long ldw2,
                               int kc2, const void* y, void* G, void* db,
                               void* counters, int R, int N, int stages,
                               void* stream) {
  const int np = g2 != nullptr ? 2 : 1;
  if (!rows_ok(R) || R > kMaxRows || N < 1 || kc < 1 || ldg < kc || ldw < kc ||
      (np == 2 && (kc2 < 1 || ldg2 < kc2 || ldw2 < kc2)) || stages < 1 ||
      dx_smem(stages) > kSmemMax || (N + kDxBN - 1) / kDxBN > rd::kMaxCounters ||
      (R > kDxRows && counters == nullptr))
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
  a.counters = reinterpret_cast<unsigned*>(counters);
  a.R = R, a.N = N, a.P = rd::pow2_at_least(R), a.stages = stages;
  a.n_kt = a.kt[0] + a.kt[1];
  if (manual && a.n_kt > stages) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return np == 2 ? dx_launch<2>(maps, a, s) : dx_launch<1>(maps, a, s);
}

// The standalone backward of a network's top layer: g the incoming gradient
// ([R, N] at row stride ldg, unit column stride; float32 when g_f32, else
// bf16), g2 a second bf16 one ([R, N] contiguous, only with a bf16 g) or 0,
// y the layer's bf16 output ([R, N] contiguous) when it has a ReLU, else 0;
// writes G (bf16 [R, N], contiguous) and db (bf16 [N]).  1 <= R <= 4,096,
// a block a 256-row tile of 8 columns; `counters` as dense_dx_launch's.
extern "C" int dense_bwd_launch(const void* g, int g_f32, long long ldg,
                                const void* g2, const void* y, void* G,
                                void* db, void* counters, int R, int N,
                                void* stream) {
  const int blocks = (N + kBwdCols - 1) / kBwdCols;
  if (!rows_ok(R) || R > kMaxRows || N < 1 || ldg < N ||
      (g_f32 && g2 != nullptr) || blocks > rd::kMaxCounters ||
      (R > kDxRows && counters == nullptr))
    return -1;
  const int vec = N % 4 == 0 && ldg % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % (g_f32 ? 16 : 8) == 0;
  const dim3 grid(blocks, (R + kDxRows - 1) / kDxRows);
  dense_bwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      g, g_f32, ldg, reinterpret_cast<const bf16*>(g2),
      reinterpret_cast<const bf16*>(y), reinterpret_cast<bf16*>(G),
      reinterpret_cast<bf16*>(db), reinterpret_cast<unsigned*>(counters), R, N,
      rd::pow2_at_least(R), vec);
  return (int)cudaGetLastError();
}
