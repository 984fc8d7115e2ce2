// hamming_cosine: per-edge SimHash sketch comparison, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hamming.py:hamming_cosine
// (body _kernel), which the approximate (LSH) path calls once per build
// through ops.simhash_edge_similarity_kernel. For every edge e:
//
//     diff[e] = sum_w popcount(sk[eu[e], w] XOR sk[ev[e], w])
//     sim[e]  = cos((pi_f32 * (float)diff[e]) / (float)samples)
//
// in exactly the reference's order (jnp.pi * diff / samples, then cos): one
// f32 product rounded once, one IEEE division, the full-precision cosf. The
// build has no --use_fast_math, so '/' and cosf are the IEEE / libdevice
// versions that torch.cos uses on the card too.
//
// What bounds it on the H100: memory. The bytes the function must move are
// the two ids and sigma of every edge (12 B) plus the sketch table once
// (n * 4 * words B). The kernel reads more: one thread per edge gathers both
// rows itself, as 16-byte vectors when words % 4 == 0. In CSR order the
// eu rows are shared by a warp's neighbouring edges, but every ev row is a
// random 32-byte sector pair, so the achieved rate sits far below that
// bound. The TPU kernel took the two rows pre-gathered to the edges; at
// com-LiveJournal scale those are two [2m, words] copies of 2.2 GB each,
// which this kernel never writes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;  // f32(pi), as jnp.pi * f32

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hamming_cosine_kernel(const uint32_t* __restrict__ sk,
                      const int32_t* __restrict__ eu,
                      const int32_t* __restrict__ ev,
                      float* __restrict__ sim, int64_t e, int words,
                      int samples) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= e) return;
  const uint32_t* ru = sk + static_cast<int64_t>(eu[i]) * words;
  const uint32_t* rv = sk + static_cast<int64_t>(ev[i]) * words;
  int diff = 0;
  if (kVec) {
    const uint4* vu = reinterpret_cast<const uint4*>(ru);
    const uint4* vv = reinterpret_cast<const uint4*>(rv);
    for (int w = 0; w < words / 4; ++w) {
      const uint4 a = __ldg(vu + w);
      const uint4 b = __ldg(vv + w);
      diff += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
              __popc(a.w ^ b.w);
    }
  } else {
    for (int w = 0; w < words; ++w) diff += __popc(__ldg(ru + w) ^ __ldg(rv + w));
  }
  const float theta =
      __fdiv_rn(__fmul_rn(kPi, static_cast<float>(diff)),
                static_cast<float>(samples));
  sim[i] = cosf(theta);
}

}  // namespace

extern "C" int hamming_cosine_launch(const void* sk, const void* eu,
                                     const void* ev, void* sim, int64_t e,
                                     int words, int samples, void* stream) {
  if (e <= 0) return 0;
  if (words <= 0 || samples <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (e + kThreads - 1) / kThreads;
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(sk) % 16 == 0;
  auto* s = static_cast<const uint32_t*>(sk);
  auto* u = static_cast<const int32_t*>(eu);
  auto* v = static_cast<const int32_t*>(ev);
  auto* out = static_cast<float*>(sim);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    hamming_cosine_kernel<true><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, st>>>(s, u, v, out, e, words, samples);
  } else {
    hamming_cosine_kernel<false><<<static_cast<unsigned int>(blocks), kThreads,
                                   0, st>>>(s, u, v, out, e, words, samples);
  }
  return static_cast<int>(cudaGetLastError());
}
