// B5g, the bf16 parameter shadows of the SAC update, on Hopper (sm_90a):
// the port of the casts XLA fuses into the products of `sac_train_step`
// (distributed_cluster_gpus_tpu/rl/sac.py:206-310): flax's bf16 `Dense`
// (rl/nets.py:37-39, 58-61, 93-95, 149-150) rounds each float32 kernel and
// bias to bf16 before its product.  The JAX package has no Pallas kernel.
// Inside an update the casts run in B5c's launches (csrc/adam.cu: the
// gradients widened as it reads them, the shadows written with the new
// parameters); this kernel fills the shadows outside the update, when a
// learned state is built and after any other write of its parameters
// (rl/sac.py `refresh_shadows`).
//
// What it computes, for each group of a table (one flat buffer each):
//   dst[i] = bf16(src[i])   (round to nearest even, as torch's
//                            `.to(bfloat16)`)
// Bound on the card: bytes.  Each element is read once and written once:
// 6 B an element; the four shadows at the published widths (enc 144,384,
// actor 69,904, critic and target 287,808 each) move 4.7 MB, 1.4 us at
// 3.35 TB/s.
// Design: one launch for all the groups of a table, every block knowing its
// group from the table's block offsets (as csrc/adam.cu's table does); a
// thread converts 8 elements with 16-byte loads and stores (two float4s and
// one uint4), the group's tail element by element.  No host read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread converts
constexpr int kMaxGroups = 8;

struct Group {
  const float* src;
  __nv_bfloat16* dst;
  long long n;
  int first_block;
};

struct Table {
  Group grp[kMaxGroups];
  int n_groups;
};

__device__ __forceinline__ int group_of(const Table& t, int block) {
  int k = 0;
  while (k + 1 < t.n_groups && block >= t.grp[k + 1].first_block) ++k;
  return k;
}

__global__ void __launch_bounds__(kThreads)
    param_pack_kernel(const __grid_constant__ Table t) {
  const Group& G = t.grp[group_of(t, blockIdx.x)];
  const long long e =
      ((long long)(blockIdx.x - G.first_block) * kThreads + threadIdx.x) * kVec;
  if (e >= G.n) return;
  const float* s = G.src + e;
  __nv_bfloat16* d = G.dst + e;
  if (e + kVec <= G.n) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    const float4 b = *reinterpret_cast<const float4*>(s + 4);
    alignas(16) __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                                       __floats2bfloat162_rn(a.z, a.w),
                                       __floats2bfloat162_rn(b.x, b.y),
                                       __floats2bfloat162_rn(b.z, b.w)};
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(h);
  } else {
    for (long long i = 0; i < G.n - e; ++i) d[i] = __float2bfloat16_rn(s[i]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  For each of n_groups groups:
// ptrs[2k], ptrs[2k+1] = src (float32), dst (bf16) on the device, both
// 16-byte aligned; ns[k] its element count.  Returns the launch's
// cudaError_t, or -1 for a bad table.
extern "C" int param_pack_launch(const uint64_t* ptrs, const long long* ns,
                                 int n_groups, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return -1;
  Table t;
  t.n_groups = n_groups;
  long long blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    Group& G = t.grp[k];
    G.src = reinterpret_cast<const float*>(ptrs[2 * k]);
    G.dst = reinterpret_cast<__nv_bfloat16*>(ptrs[2 * k + 1]);
    G.n = ns[k];
    G.first_block = (int)blocks;
    if (G.n < 1 || ptrs[2 * k] % 16 != 0 || ptrs[2 * k + 1] % 16 != 0)
      return -1;
    blocks += (G.n + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
    if (blocks > 2147483647LL) return -1;
  }
  param_pack_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
