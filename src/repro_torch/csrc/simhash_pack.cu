// simhash_pack: dense SimHash sketches sign(W * R) packed to bits, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/simhash.py:simhash_pack
// (body _kernel): the closed weighted adjacency W (n x n) times the gaussian
// projections R (n x k), with the sign taken and 32 sample bits packed into
// each uint32 word before the store, so the product never reaches device
// memory. Bit s of word w of row v is (W * R)[v, 32 w + s] >= 0.
//
// What bounds it on the H100: operations. 2 n^2 k flops against 4 n^2 bytes
// of W (R and the sketches are n k / 8 times smaller) is far above the
// card's FP32 balance, so the limit is the 67 TFLOP/s of the FP32 units.
// This first version is the tiled SGEMM of masked_gram.cu: 64 x 64 output
// tiles, 16-deep k slabs staged through shared memory, 256 threads with a
// 4 x 4 register tile each, plain IEEE FMA (no TF32, no tensor cores: TF32
// would round weighted W and gaussian R and flip sign bits near 0). The
// epilogue stages the 64 x 64 tile of sums in shared memory; then each warp
// takes (row, word) pairs, lane s reads sample column 32 w + s of the row,
// and __ballot_sync(~0u, acc >= 0.f) is the packed word: bit s = lane s,
// the reference's layout. The wrapper zero-pads n and k to multiples of 64;
// zero R columns give bit 1 on every row, as the reference's zeroed
// padding samples do.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;   // output tile edge (rows x sample columns)
constexpr int kSlab = 16;   // contraction depth per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
simhash_pack_kernel(const float* __restrict__ w, const float* __restrict__ r,
                    uint32_t* __restrict__ out, int n, int k) {
  __shared__ float As[kSlab][kTile];
  __shared__ float Bs[kSlab][kTile];
  __shared__ float Cs[kTile][kTile + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile;   // vertex rows
  const int j0 = blockIdx.x * kTile;   // sample columns
  const int lr = threadIdx.x / 4;        // A: tile row this thread loads
  const int lc = (threadIdx.x % 4) * 4;  // A: k offset of its float4
  const int br = threadIdx.x / 16;       // B: slab row this thread loads
  const int bc = (threadIdx.x % 16) * 4; // B: column of its float4

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const float* arow = w + static_cast<int64_t>(i0 + lr) * n + lc;
  const float* bptr = r + static_cast<int64_t>(br) * k + j0 + bc;
  for (int k0 = 0; k0 < n; k0 += kSlab) {
    const float4 av = *reinterpret_cast<const float4*>(arow + k0);
    const float4 bv = *reinterpret_cast<const float4*>(
        bptr + static_cast<int64_t>(k0) * k);
    As[lc + 0][lr] = av.x; As[lc + 1][lr] = av.y;
    As[lc + 2][lr] = av.z; As[lc + 3][lr] = av.w;
    *reinterpret_cast<float4*>(&Bs[br][bc]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float ar[4], bb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ar[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bb[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], bb[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) Cs[ty + 16 * a][tx + 16 * b] = acc[a][b];
  __syncthreads();

  // 64 rows x 2 words per tile; 8 warps take 16 (row, word) pairs each
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = k / 32;
  for (int p = warp; p < kTile * (kTile / 32); p += kThreads / 32) {
    const int row = p / (kTile / 32);
    const int wd = p % (kTile / 32);
    const unsigned bits = __ballot_sync(~0u, Cs[row][32 * wd + lane] >= 0.0f);
    if (lane == 0)
      out[static_cast<int64_t>(i0 + row) * words + j0 / 32 + wd] = bits;
  }
}

}  // namespace

extern "C" int simhash_pack_launch(const void* w, const void* r, void* out,
                                   int n, int k, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (n % kTile != 0 || k % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(k / kTile, n / kTile);
  simhash_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(r),
      static_cast<uint32_t*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}
