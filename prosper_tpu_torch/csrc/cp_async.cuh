// Asynchronous copies from device memory to shared memory (cp.async, sm_80
// and later), as the kernels that stage tiles use them (sgemm.cu,
// bigs_multi.cu): a thread starts copies, commits them as a group and waits
// for all but the newest N groups before a block barrier hands the tile over.
#pragma once

#include <cuda_runtime.h>

// 16 bytes, both addresses 16-byte aligned; with pred false nothing is read
// and the destination is filled with zeros.
__device__ inline void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}

__device__ inline void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
