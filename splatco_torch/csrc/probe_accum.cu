// Accumulation into a pre-zeroed output over sequential steps: a probe of
// carrying a sum across steps in the output buffer itself.
//
// Replaces the TPU kernel `acc_kernel` of tools/micro_mosaic.py: a grid
// of 4 sequential steps whose output aliases a zeros input
// (`input_output_aliases={1: 0}`) and adds the input on the even steps,
// so every element ends at 2.0 for an input of ones.  The function: for
// step in 0 .. steps-1, if step is even, out += in.  Here `out` is the
// caller's zeroed buffer, updated in place (the PyTorch counterpart of
// the alias); the sequential grid becomes a loop inside each thread, one
// thread per element.  What bounds it: bytes (in and out read, out
// written once); at the probe's 8 x 128 the launch itself dominates.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
accum_kernel(const float* __restrict__ in, float* __restrict__ out,
             long long n, int steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = out[i];
  const float v = in[i];
  for (int step = 0; step < steps; ++step) {
    if (step % 2 == 0) acc = acc + v;
  }
  out[i] = acc;
}

}  // namespace

// in, out: [n] float32, out updated in place.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int probe_accum(const float* in, float* out, long long n,
                           int steps, void* stream) {
  if (n > 0) {
    accum_kernel<<<(int)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        in, out, n, steps);
  }
  return (int)cudaGetLastError();
}
