// Stage stamps: the card's clock written into a program's stamp buffer.
//
// No TPU kernel corresponds to it.  The detector's programs launch this
// one-thread kernel at their start, at the start of each top-level stage
// group and before their readback is packed (pipeline/timings.py,
// "Stage stamps").  Captured into a program key's CUDA graph, it runs at
// every replay, so the differences of consecutive stamps are each group's
// device time inside replays, where no host range is entered.  The buffer
// travels back in the program's own packed readback: no event, no extra
// copy, no synchronise.
//
// %globaltimer is the card's global nanosecond timer.  A stamp runs when
// the stream reaches it, after the kernels queued before it have finished;
// it costs one launch inside the graph, about a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_stamp_kernel(int64_t* buf, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = static_cast<int64_t>(t);
}

}  // namespace

extern "C" int fdt_stage_stamp(void* buf, int slot, int device,
                               void* stream) {
  // `device` is made current for the launch only, as in warp.cu.
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(buf), slot);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
