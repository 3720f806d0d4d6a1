// B5g, the bf16 parameter shadows and the gradient pack of the SAC update,
// on Hopper (sm_90a): the port of the casts XLA fuses into the products of
// `sac_train_step` (distributed_cluster_gpus_tpu/rl/sac.py:206-310): flax's
// bf16 `Dense` (rl/nets.py:37-39, 58-61, 93-95, 149-150) rounds each
// float32 kernel and bias to bf16 before its product, and the transpose of
// that cast widens each bf16 parameter gradient back to float32 for optax.
// The JAX package has no Pallas kernel.
//
// What it computes, for each group of a table (one flat buffer each: the
// update's parameter groups, or their gradients):
//   to_bf16 = 1:  dst[i] = bf16(src[i])   (float32 -> bf16, round to nearest
//                                          even, as torch's `.to(bfloat16)`)
//   to_bf16 = 0:  dst[i] = float(src[i])  (bf16 -> float32, exact)
// Bound on the card: bytes.  Each element is read once and written once:
// 6 B an element; the four shadows at the published widths (enc 144,384,
// actor 69,904, critic and target 287,808 each) move 4.7 MB, 1.4 us at
// 3.35 TB/s, the three gradients 3.0 MB.
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
  const void* src;
  void* dst;
  long long n;
  int first_block, to_bf16;
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
  if (G.to_bf16) {
    const float* s = reinterpret_cast<const float*>(G.src) + e;
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(G.dst) + e;
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
  } else {
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(G.src) + e;
    float* d = reinterpret_cast<float*>(G.dst) + e;
    if (e + kVec <= G.n) {
      const uint4 u = *reinterpret_cast<const uint4*>(s);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      float2 f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
      *reinterpret_cast<float4*>(d) = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
    } else {
      for (long long i = 0; i < G.n - e; ++i) d[i] = __bfloat162float(s[i]);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  For each of n_groups groups:
// ptrs[2k], ptrs[2k+1] = src, dst on the device, both 16-byte aligned;
// ns[k] its element count; to_bf16[k] 1 for float32 -> bf16, 0 for bf16 ->
// float32.  Returns the launch's cudaError_t, or -1 for a bad table.
extern "C" int param_pack_launch(const uint64_t* ptrs, const long long* ns,
                                 const int* to_bf16, int n_groups,
                                 void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return -1;
  Table t;
  t.n_groups = n_groups;
  long long blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    Group& G = t.grp[k];
    G.src = reinterpret_cast<const void*>(ptrs[2 * k]);
    G.dst = reinterpret_cast<void*>(ptrs[2 * k + 1]);
    G.n = ns[k];
    G.to_bf16 = to_bf16[k] != 0;
    G.first_block = (int)blocks;
    if (G.n < 1 || ptrs[2 * k] % 16 != 0 || ptrs[2 * k + 1] % 16 != 0)
      return -1;
    blocks += (G.n + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
    if (blocks > 2147483647LL) return -1;
  }
  param_pack_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
