// stamp: one (tag, %globaltimer) record into a ring on the card, the
// device half of `ibx_torch.utils.monitor.device_span`.
//
// One thread takes the next slot by an atomic add on the ring's head and
// writes the tag and the global timer (nanoseconds, the clock every SM
// shares) there. A head past the capacity writes nothing: the host reads
// min(head, capacity) rows and counts the rest as dropped. Being a kernel,
// a stamp runs in stream order between the kernels around it, eagerly or
// as a node of a captured CUDA graph (each replay takes fresh slots).

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ slots,
                             unsigned long long* __restrict__ head,
                             long long capacity, long long tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = atomicAdd(head, 1ULL);
  if (i < (unsigned long long)capacity) {
    slots[2 * i] = tag;
    slots[2 * i + 1] = (long long)t;
  }
}

}  // namespace

// slots: int64 [capacity, 2]; head: int64 [1]. Returns cudaGetLastError()
// after the launch.
extern "C" int ibx_stamp(long long* slots, long long* head,
                         long long capacity, long long tag, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      slots, reinterpret_cast<unsigned long long*>(head), capacity, tag);
  return (int)cudaGetLastError();
}
