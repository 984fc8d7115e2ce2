// bucket_probe: shared-neighbor dot and count per edge, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_probe.py:bucket_probe
// (body _kernel), which the degree-bucketed similarity engine calls once per
// (probe class, target class, tile shape) group chunk. For every edge e:
//
//     dot[e] = sum_i w_p[e,i] * w_t[e,j(i)]   over probe ids found in the target row
//     cnt[e] = number of probe ids found in the target row
//
// Contract (the rows the engine's _gather_tiled_rows produces): both rows of
// an edge are sorted ascending with distinct real ids < n, and every pad id
// is >= n and sits after the real ids (the engine pads with id n; hub rows
// stay sorted across their tiles because the unused tiles are all-pad
// sentinel rows). So pads need no sanitising: a probe pad ends the probe
// scan, and a target pad never equals a real probe id. There is no block
// multiple on e or T.
//
// What bounds it on the H100: memory. Each edge does P binary searches of
// log2(T) steps on rows of 32..2048 ids, a few integer compares per byte
// loaded, far below the card's operations-per-byte balance. The TPU kernel
// compared all P x T pairs per edge; a 131072-wide hub target row makes that
// 2^17 compares per probe id, so this design searches instead: one warp per
// edge, lane l takes probe ids l, l+32, ..., binary-searches each in the
// target row in global memory (the row's sectors stay in L1 across the
// warp's searches), and the warp reduces (dot, cnt) with shuffles. Each term
// is one float32 product rounded once (__fmul_rn, no FMA contraction), as
// in the plain version; the terms are summed in float64 and the total is
// rounded to float32 once, so the only difference from the plain version is
// the plain version's own float32 summation error (a hub-hub edge sums
// thousands of terms). Unweighted dots are small integers: bit-identical.
// The sigma epilogue (division, sqrt) stays outside, in one torch
// implementation.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bucket_probe_kernel(const int32_t* __restrict__ p_ids,
                    const float* __restrict__ p_w,
                    const int32_t* __restrict__ t_ids,
                    const float* __restrict__ t_w,
                    float* __restrict__ dot, int32_t* __restrict__ cnt,
                    int64_t e, int P, int T, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t edge =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (edge >= e) return;  // whole warp leaves together
  const int32_t* prow = p_ids + edge * P;
  const float* pw = p_w + edge * P;
  const int32_t* trow = t_ids + edge * T;
  const float* tw = t_w + edge * T;

  double acc = 0.0;
  int hits = 0;
  for (int i = lane; i < P; i += 32) {
    const int32_t x = prow[i];
    if (x >= n) break;  // sorted: every later probe entry is a pad too
    int lo = 0, hi = T;  // lower_bound of x in trow[0, T)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (trow[mid] < x) lo = mid + 1; else hi = mid;
    }
    if (lo < T && trow[lo] == x) {
      acc += static_cast<double>(__fmul_rn(pw[i], tw[lo]));
      ++hits;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  }
  if (lane == 0) {
    dot[edge] = __double2float_rn(acc);
    cnt[edge] = hits;
  }
}

}  // namespace

extern "C" int bucket_probe_launch(const void* p_ids, const void* p_w,
                                   const void* t_ids, const void* t_w,
                                   void* dot, void* cnt, int64_t e, int P,
                                   int T, int n, void* stream) {
  if (e <= 0) return 0;
  const int64_t blocks = (e + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bucket_probe_kernel<<<static_cast<unsigned int>(blocks),
                        32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p_ids), static_cast<const float*>(p_w),
      static_cast<const int32_t*>(t_ids), static_cast<const float*>(t_w),
      static_cast<float*>(dot), static_cast<int32_t*>(cnt), e, P, T, n);
  return static_cast<int>(cudaGetLastError());
}
