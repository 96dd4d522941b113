// An opt-in timing mode for the persistent kernels (K5, K6): the kernel's
// own span on the device, read from %globaltimer inside it.
//
// The buffer holds NSTAMP unsigned 64-bit nanosecond stamps:
//   [0] CTA 0's entry, [1] CTA 0 after the set-up passes, [2] CTA 0
//   before its exit, [3] the earliest entry of any CTA, [4] the latest
//   exit of any CTA.
// The caller fills [3] with ~0 and the rest with 0 before the launch
// (stencils/stamps.py).  A null buffer turns the mode off: every stamp is
// behind one uniform test of the pointer.

#pragma once

namespace stamp {

constexpr int NSTAMP = 5;
constexpr int ENTRY0 = 0, SETUP0 = 1, EXIT0 = 2, MIN_ENTRY = 3,
              MAX_EXIT = 4;

__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// at the kernel's first instruction, by every thread of every CTA
__device__ __forceinline__ void entry(unsigned long long* s) {
  if (s != nullptr && threadIdx.x == 0) {
    const unsigned long long t = now();
    if (blockIdx.x == 0) s[ENTRY0] = t;
    atomicMin(&s[MIN_ENTRY], t);
  }
}

// after the set-up passes, by every thread of every CTA
__device__ __forceinline__ void setup(unsigned long long* s) {
  if (s != nullptr && blockIdx.x == 0 && threadIdx.x == 0) s[SETUP0] = now();
}

// after the CTA's last store, by every thread of every CTA
__device__ __forceinline__ void leave(unsigned long long* s) {
  if (s != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long t = now();
      if (blockIdx.x == 0) s[EXIT0] = t;
      atomicMax(&s[MAX_EXIT], t);
    }
  }
}

}  // namespace stamp
