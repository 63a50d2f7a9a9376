// Tri-plane bilinear sample, backward: a deterministic scatter of the
// output's cotangent onto the plane's texels, and the coordinates'
// gradients.
//
// Replaces no Pallas kernel: `jax.grad` of the XLA gather in
// `_sample_plane` (splatco_tpu/models/triplane.py:51) is an XLA
// scatter-add.  The port's autograd emitted `index_put_(accumulate=True)`
// for it, which on the card sorts the indices and walks all entries of
// one texel serially in one warp, 5 of whose 32 lanes have work: after a
// capacity regrowth ~65,000 zero padding rows sample the same four
// texels, and those walks took 186 ms of a 390 ms trained step (PERF.md).
//
// Computes what `plane_sample_bwd_plain` (splatco_torch/ops/
// plane_sample.py) computes, sum for sum:
//   d_plane[r, cell] = the sum over the key table's entries of `cell` of
//     g[n, r] * weight(n, k), where the table holds every (row n,
//     corner k) in cell order (torch.sort, stable, on the forward's keys;
//     a corner off the plane has key H * W and sorts after every cell);
//   d_u[n] = (sum over r of g[n, r] * ((1 - ty) (c10 - c00)
//     + ty (c11 - c01))) * (H - 1) * 0.5, d_v likewise on the other axis,
//     the corner values masked to 0 off the plane (floor, clamp and the
//     mask carry no gradient).
// No float atomics: each sum's order is fixed by the table alone.  The
// table is cut into chunks of kChunk entries, one block each.  A block
// sums each run of equal keys within its chunk by a segmented
// Hillis-Steele scan (log2 kChunk steps, each entry adding the one d
// places before it while their keys agree) and writes a run that starts
// and ends inside the chunk straight to d_plane.  A run that crosses a
// chunk's end leaves the chunk's part in `tail` (its last chunk's part in
// `head`, and a chunk wholly inside it both); then one warp per run that
// starts in a chunk and crosses its end adds the run's parts: its first
// chunk's tail part, then the head parts of the following chunks, 32 at
// a time, each 32 summed by a fixed xor butterfly.  A run of 65,000
// entries is thus 254 chunks scanned in parallel and 8 butterfly rounds,
// not a serial walk.  Texels no entry reaches are zeroed first.
//
// What bounds it: bytes, d_plane written once (every texel), the table
// and g read once, the coordinates and corner texels of each row
// gathered from L2.
#include "plane_sample.cuh"

namespace {

using plane_sample::Cell;
using plane_sample::cell_of;
using plane_sample::corner;

constexpr int kChunk = 256;  // table entries a block
constexpr int kSpanWarps = 8;

__global__ void __launch_bounds__(kChunk)
sample_chunk_sums(const int* __restrict__ keys,
                  const long long* __restrict__ order, long long total,
                  const float* __restrict__ g, long long sg,
                  const float* __restrict__ u, long long su,
                  const float* __restrict__ v, long long sv, int r, int h,
                  int w, float* __restrict__ d_plane,
                  float* __restrict__ head, float* __restrict__ tail) {
  __shared__ int s_key[kChunk];
  __shared__ float s_val[kChunk];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk;
  const long long i = base + t;
  const int cells = h * w;
  const int key = i < total ? keys[i] : cells;
  const bool valid = key < cells;
  long long row = 0;
  float wgt = 0.0f;
  if (valid) {
    const long long e = order[i];
    row = e >> 2;
    bool inb;
    int idx;
    wgt = corner(cell_of(u[row * su], v[row * sv], h, w), (int)(e & 3), h,
                 w, &inb, &idx);
  }
  s_key[t] = key;
  __syncthreads();
  const bool last = t == kChunk - 1 || s_key[t + 1] != key;
  const bool started_before =
      s_key[0] == key && blockIdx.x > 0 && keys[base - 1] == key;
  const bool continues_after = t == kChunk - 1 && base + kChunk < total &&
                               keys[base + kChunk] == key;
  for (int ch = 0; ch < r; ++ch) {
    float val = valid ? g[row * sg + ch] * wgt : 0.0f;
    for (int d = 1; d < kChunk; d <<= 1) {
      __syncthreads();
      s_val[t] = val;
      __syncthreads();
      if (t >= d && s_key[t - d] == key) val = s_val[t - d] + val;
    }
    if (last && valid) {
      if (continues_after) tail[blockIdx.x * (long long)r + ch] = val;
      if (started_before) head[blockIdx.x * (long long)r + ch] = val;
      if (!continues_after && !started_before)
        d_plane[(long long)ch * cells + key] = val;
    }
  }
}

__global__ void __launch_bounds__(32 * kSpanWarps)
sample_span_sums(const int* __restrict__ keys, long long total,
                 long long chunks, int r, int cells,
                 const float* __restrict__ head,
                 const float* __restrict__ tail, float* __restrict__ d_plane) {
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long end = (b + 1) * kChunk;  // the next chunk's first entry
  if (b >= chunks || end >= total) return;
  const int key = keys[end - 1];
  if (key >= cells || keys[end] != key) return;  // no run crosses the end
  const long long base = b * kChunk;
  if (b > 0 && keys[base] == key && keys[base - 1] == key) return;
  for (int ch = 0; ch < r; ++ch) {
    float acc = tail[b * r + ch];
    for (long long first = b + 1;; first += 32) {
      const long long j = first + lane;
      const bool in = j < chunks && keys[j * kChunk] == key;
      float x = in ? head[j * r + ch] : 0.0f;
      for (int o = 16; o > 0; o >>= 1)
        x = x + __shfl_xor_sync(0xffffffffu, x, o);
      acc = acc + x;
      const long long next = first + 32;  // the next round's first chunk
      if (!(next < chunks && keys[next * kChunk] == key)) break;
    }
    if (lane == 0) d_plane[(long long)ch * cells + key] = acc;
  }
}

__global__ void __launch_bounds__(256)
sample_coord_grads(const float* __restrict__ plane,
                   const float* __restrict__ g, long long sg,
                   const float* __restrict__ u, long long su,
                   const float* __restrict__ v, long long sv, long long n,
                   int r, int h, int w, float* __restrict__ d_u,
                   float* __restrict__ d_v) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const Cell c = cell_of(u[row * su], v[row * sv], h, w);
  float m[4];
  int idx[4];
  for (int k = 0; k < 4; ++k) {
    bool inb;
    corner(c, k, h, w, &inb, &idx[k]);
    m[k] = inb ? 1.0f : 0.0f;
  }
  const long long cells = (long long)h * w;
  float dtx = 0.0f, dty = 0.0f;
  for (int ch = 0; ch < r; ++ch) {
    const float* p = plane + ch * cells;
    const float c00 = p[idx[0]] * m[0], c10 = p[idx[1]] * m[1];
    const float c01 = p[idx[2]] * m[2], c11 = p[idx[3]] * m[3];
    const float gr = g[row * sg + ch];
    dtx = dtx + gr * ((1.0f - c.ty) * (c10 - c00) + c.ty * (c11 - c01));
    dty = dty + gr * ((1.0f - c.tx) * (c01 - c00) + c.tx * (c11 - c10));
  }
  d_u[row] = (dtx * (float)(h - 1)) * 0.5f;
  d_v[row] = (dty * (float)(w - 1)) * 0.5f;
}

}  // namespace

// g: [n, r] float32, row stride sg, channels contiguous; u, v: [n]
// float32 with element strides su, sv; plane: [r, h, w] float32,
// contiguous.  With d_plane given ([r, h, w], written whole): keys [total]
// int32 sorted and order [total] int64 (the key table: entry e = 4 n + k
// of the forward's keys), head and tail [ceil(total / 256), r] float32
// scratch.  With d_u given, d_u and d_v [n] float32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int plane_sample_bwd(const float* g, long long sg, const float* u,
                                long long su, const float* v, long long sv,
                                const float* plane, long long n, int r, int h,
                                int w, const int* keys,
                                const long long* order, long long total,
                                float* head, float* tail, float* d_plane,
                                float* d_u, float* d_v, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d_plane != nullptr) {
    const long long cells = (long long)h * w;
    cudaError_t err =
        cudaMemsetAsync(d_plane, 0, sizeof(float) * r * cells, s);
    if (err != cudaSuccess) return (int)err;
    const long long chunks = (total + kChunk - 1) / kChunk;
    if (chunks > 0) {
      sample_chunk_sums<<<(unsigned)chunks, kChunk, 0, s>>>(
          keys, order, total, g, sg, u, su, v, sv, r, h, w, d_plane, head,
          tail);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long threads = 32 * chunks;
      const int block = 32 * kSpanWarps;
      sample_span_sums<<<(unsigned)((threads + block - 1) / block), block, 0,
                         s>>>(keys, total, chunks, r, (int)cells, head, tail,
                              d_plane);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (d_u != nullptr && n > 0) {
    sample_coord_grads<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        plane, g, sg, u, su, v, sv, n, r, h, w, d_u, d_v);
  }
  return (int)cudaGetLastError();
}
