// A span's stamp (snd_vae_tpu_torch/spans.py): one thread writes the card's
// global nanosecond timer, %globaltimer, into stamps[row * cols + k].  The
// row is read from the device (the captured train step's row counter), so a
// CUDA graph that captured the launch writes each replay's stamps into that
// replay's row.  It replaces no TPU kernel: the JAX package has no spans
// inside its step.  Bound by the launch (one thread, one 8-byte store); the
// timer may tick only every microsecond, and every span it marks is tens of
// microseconds or longer.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void span_stamp_kernel(int64_t* stamps, const int64_t* row, int rows, int cols,
                                  int k) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int64_t r = *row;
  if (r >= 0 && r < rows && k >= 0 && k < cols) {
    stamps[r * cols + k] = static_cast<int64_t>(now);
  }
}

extern "C" int span_stamp_launch(void* stamps, const void* row, int rows, int cols, int k,
                                 void* stream) {
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(stamps), static_cast<const int64_t*>(row), rows, cols, k);
  return static_cast<int>(cudaGetLastError());
}
