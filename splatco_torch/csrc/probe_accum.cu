// Accumulation into a pre-zeroed output over sequential steps: a probe of
// carrying a sum across steps in the output buffer itself.
//
// Replaces the TPU kernel `acc_kernel` of tools/micro_mosaic.py: a grid
// of 4 sequential steps whose output aliases a zeros input
// (`input_output_aliases={1: 0}`) and adds the input on the even steps,
// so every element ends at 2.0 for an input of ones.  The function: for
// step in 0 .. steps-1, if step is even, out += in, rounded at each step
// as the plain version's `out.add_(in)` is: ceil(steps / 2) adds.  Here
// `out` is the caller's buffer, updated in place (the PyTorch counterpart
// of the alias); the sequential grid becomes a loop inside each thread.
//
// What bounds it: bytes (in and out read, out written once); at the
// probe's 8 x 128 the launch itself.  The design moves 16 B a thread:
// where in and out sit at the same offset modulo 16 B, the wrapper's plan
// (`accum_plan` in splatco_torch/ops/probes.py) splits [0, n) into a head
// of up to 3 elements before the first 16 B boundary, `nvec` float4s and
// a tail of up to 3; a thread takes one float4, and the head's and the
// tail's elements take a thread each after them, in the same launch.
// Otherwise every element takes a thread.  Indices are 32-bit while n
// and the grid's threads fit, and the grid is the plan's, sized to its
// units.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // probes.ACCUM_THREADS

template <typename Index>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float* __restrict__ in, float* __restrict__ out, Index n,
             Index head, Index nvec, int adds) {
  const Index i = (Index)blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    const float4 v = reinterpret_cast<const float4*>(in + head)[i];
    float4 a = reinterpret_cast<float4*>(out + head)[i];
    for (int r = 0; r < adds; ++r) {
      a.x = a.x + v.x;
      a.y = a.y + v.y;
      a.z = a.z + v.z;
      a.w = a.w + v.w;
    }
    reinterpret_cast<float4*>(out + head)[i] = a;
    return;
  }
  const Index j = i - nvec;  // the head's elements, then the tail's
  if (j >= n - 4 * nvec) return;
  const Index e = j < head ? j : j + 4 * nvec;
  float a = out[e];
  const float v = in[e];
  for (int r = 0; r < adds; ++r) a = a + v;
  out[e] = a;
}

}  // namespace

// in, out: [n] float32, out updated in place; head, nvec and blocks are
// the wrapper's plan (16 B vectors from element `head`, the grid).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int probe_accum(const float* in, float* out, long long n,
                           int steps, long long head, long long nvec,
                           long long blocks, void* stream) {
  if (n > 0) {
    const int adds = steps > 0 ? (steps + 1) / 2 : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (n < (1LL << 31) && blocks * kThreads < (1LL << 31)) {
      accum_kernel<int><<<(unsigned)blocks, kThreads, 0, st>>>(
          in, out, (int)n, (int)head, (int)nvec, adds);
    } else {
      accum_kernel<long long><<<(unsigned)blocks, kThreads, 0, st>>>(
          in, out, n, head, nvec, adds);
    }
  }
  return (int)cudaGetLastError();
}
