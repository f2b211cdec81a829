// Pieces shared by the split-K cluster decode templates for Hopper
// (sm_90a): int8_matmul.cu, int4_matmul.cu and int4_exp.cu (namespace dec
// of each), and the warp sum of decode_attention.cu.
//
//   * ld_stream: a 4-byte weight load that bypasses L1 (each weight byte
//     is read once), 0 where the lane's column is past the end.
//   * prmt: PTX prmt.b32 in its default mode, for selectors with the
//     sign-replicating bit set, which __byte_perm does not take.
//   * warp_sum: a butterfly sum over the 32 lanes; every lane gets it.
//   * resident_clusters / launch_persistent: a template's clusters are
//     persistent over its column tiles, so a launch starts as many as fit
//     on the card at once (at most one a tile). That count is queried once
//     per kernel, device and shared-memory size and kept for a few sizes:
//     a decode step alternates K = 4096 and 11008.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splitk {

__device__ __forceinline__ uint32_t ld_stream(const int8_t* p, bool ok) {
  uint32_t v;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %2, 0;\n\t"
      "mov.b32 %0, 0;\n\t"
      "@q ld.global.nc.L1::no_allocate.b32 %0, [%1];\n\t}"
      : "=r"(v)
      : "l"(p), "r"((int)ok));
  return v;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The clusters of KSPLIT blocks (cluster dims (1, KSPLIT, 1)) of THREADS
// threads with smem bytes of dynamic shared memory that fit on the card at
// once for Kernel. The first query on a device raises the kernel's limit
// of dynamic shared memory to SMEM_MAX, every size the template takes.
template <auto Kernel, int KSPLIT, int THREADS, int SMEM_MAX>
cudaError_t resident_clusters(int smem, int* n) {
  constexpr int DEVS = 16, WAYS = 4;
  static bool opened[DEVS];
  static int cached_smem[DEVS][WAYS], cached_n[DEVS][WAYS], next_way[DEVS];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool keep = dev < DEVS;
  if (keep)
    for (int w = 0; w < WAYS; ++w)
      if (cached_n[dev][w] > 0 && cached_smem[dev][w] == smem) {
        *n = cached_n[dev][w];
        return cudaSuccess;
      }
  if (!keep || !opened[dev]) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (keep) opened[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, KSPLIT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  e = cudaOccupancyMaxActiveClusters(n, (const void*)Kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (*n < 1) return cudaErrorInvalidConfiguration;
  if (keep) {
    const int w = next_way[dev];
    cached_smem[dev][w] = smem;
    cached_n[dev][w] = *n;
    next_way[dev] = (w + 1) % WAYS;
  }
  return cudaSuccess;
}

// Kernel(a) on a grid of (clusters, KSPLIT) blocks: one cluster a column
// tile, at most as many as fit on the card at once.
template <auto Kernel, int KSPLIT, int THREADS, int SMEM_MAX, class Args>
cudaError_t launch_persistent(const Args& a, int tiles, int smem, cudaStream_t stream) {
  int n = 0;
  const cudaError_t e = resident_clusters<Kernel, KSPLIT, THREADS, SMEM_MAX>(smem, &n);
  if (e != cudaSuccess) return e;
  Kernel<<<dim3(tiles < n ? tiles : n, KSPLIT), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace splitk
