// masked_gram: (W * W^T) (.) M in plain FP32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/triangle_count.py:masked_gram
// (body _kernel): the closed weighted adjacency W (n x n) times its
// transpose, masked elementwise by M = A + I before the store, so only edge
// positions and the diagonal (squared norms) survive. It is the dense sigma
// oracle that bucketed sigma is held against.
//
// What bounds it on the H100: operations. 2 n^3 flops against 12 n^2 bytes
// (W and M read once, the product written once) is far above the card's
// FP32 balance, so the limit is the 67 TFLOP/s of the FP32 units. This
// first version is the classic shared-memory tiled SGEMM: 64 x 64 output
// tiles, 16-deep k slabs staged through shared memory, 256 threads with a
// 4 x 4 register tile each, FMA accumulation. No TF32 and no tensor cores:
// the mask is applied in registers, and unweighted W (0/1 entries) gives
// integer sums that are exact in any order, so the result is bit-identical
// to the plain (W @ W.T) * M with TF32 off. The wrapper zero-pads n to a
// multiple of 64; both operand tiles are rows of W (B = W^T), loaded as
// float4.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;   // output tile edge
constexpr int kSlab = 16;   // k depth per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
masked_gram_kernel(const float* __restrict__ w, const float* __restrict__ mask,
                   float* __restrict__ out, int n) {
  __shared__ float As[kSlab][kTile];
  __shared__ float Bs[kSlab][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int lr = threadIdx.x / 4;        // tile row this thread loads
  const int lc = (threadIdx.x % 4) * 4;  // k offset of its float4

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const float* arow = w + static_cast<int64_t>(i0 + lr) * n + lc;
  const float* brow = w + static_cast<int64_t>(j0 + lr) * n + lc;
  for (int k0 = 0; k0 < n; k0 += kSlab) {
    const float4 av = *reinterpret_cast<const float4*>(arow + k0);
    const float4 bv = *reinterpret_cast<const float4*>(brow + k0);
    As[lc + 0][lr] = av.x; As[lc + 1][lr] = av.y;
    As[lc + 2][lr] = av.z; As[lc + 3][lr] = av.w;
    Bs[lc + 0][lr] = bv.x; Bs[lc + 1][lr] = bv.y;
    Bs[lc + 2][lr] = bv.z; Bs[lc + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ar[a] = As[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) br[b] = Bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t idx = row * n + (j0 + tx + 16 * b);
      out[idx] = __fmul_rn(acc[a][b], mask[idx]);
    }
  }
}

}  // namespace

extern "C" int masked_gram_launch(const void* w, const void* mask, void* out,
                                  int n, void* stream) {
  if (n <= 0) return 0;
  if (n % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kTile, n / kTile);
  masked_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(mask),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
