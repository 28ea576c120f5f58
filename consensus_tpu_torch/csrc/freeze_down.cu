// Kernel KAI: the SPEC §6c freeze of the PBFT engines, in place.
//
// Replaces: consensus_tpu/ops/adversary.py freeze_down (K13, lines 133-140)
// as engines/pbft.py (lines 368-373) and engines/pbft_bcast.py (lines
// 677-684) call it at the end of a round: every leaf of a node down at the
// round's end takes its frozen value, the one it entered the round with
// after the recovery reset. Up to eight leaves [B, N, ...] a launch, each a
// (dst, src) pair of the same shape with its row size in bytes; where bit k
// of `resets` is set and the node recovered this round, leaf k's frozen
// value is 0 (PBFT's view and timer).
//
// The PBFT rounds compute every node's round as the JAX package does, down
// nodes included (their in-round slots feed the telemetry, which kernel KAA
// reads after the tallies), so the freeze runs last, after KAA, as a launch
// of its own.
//
// Bound: the down nodes' rows, read once and written once. Design: a grid
// whose y is the leaf and whose x covers each node's row in units of 16, 8,
// 4 or 1 bytes (the largest that divides the leaf's row size), a thread a
// unit: a thread of a down node copies its unit (or writes 0), the others
// read the node's flag byte and stop, so a warp reads and writes
// consecutive bytes. (A warp per node, copying its rows leaf by leaf, took
// 0.29 ms a call on pbft-100k-bcast's round, 6.7x its bound, on the H100.)
#include <cuda_runtime.h>

#include "crash.cuh"

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;

struct Leaves {
  unsigned char* dst[kMaxLeaves];
  const unsigned char* src[kMaxLeaves];
  int row_bytes[kMaxLeaves];
  int unit[kMaxLeaves];  // bytes a thread copies: 16, 8, 4 or 1
};

template <class T>
__device__ __forceinline__ void move(unsigned char* dst,
                                     const unsigned char* src, long long at,
                                     bool zero) {
  *reinterpret_cast<T*>(dst + at) =
      zero ? T{} : *reinterpret_cast<const T*>(src + at);
}

// Grid (ceil(B * N * most units a row / kThreads), leaves).
__global__ void freeze_kernel(const unsigned char* __restrict__ flags,
                              Leaves leaves, unsigned resets,
                              long long nodes) {
  const int k = blockIdx.y;
  const int unit = leaves.unit[k];
  const int per_row = leaves.row_bytes[k] / unit;
  const long long u =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= nodes * per_row) return;
  const unsigned char f = flags[u / per_row];
  if ((f & ctt::CRASH_DOWN) == 0) return;
  const bool zero = (f & ctt::CRASH_REC) && ((resets >> k) & 1u);
  const long long at = u * unit;
  unsigned char* dst = leaves.dst[k];
  const unsigned char* src = leaves.src[k];
  if (unit == 16)
    move<uint4>(dst, src, at, zero);
  else if (unit == 8)
    move<uint2>(dst, src, at, zero);
  else if (unit == 4)
    move<uint32_t>(dst, src, at, zero);
  else
    move<unsigned char>(dst, src, at, zero);
}

}  // namespace

extern "C" int ctt_freeze_down(
    const unsigned char* flags, unsigned char* d0, const unsigned char* s0,
    unsigned char* d1, const unsigned char* s1, unsigned char* d2,
    const unsigned char* s2, unsigned char* d3, const unsigned char* s3,
    unsigned char* d4, const unsigned char* s4, unsigned char* d5,
    const unsigned char* s5, unsigned char* d6, const unsigned char* s6,
    unsigned char* d7, const unsigned char* s7, int b0, int b1, int b2,
    int b3, int b4, int b5, int b6, int b7, unsigned resets, int B, int N,
    cudaStream_t st) {
  const long long nodes = static_cast<long long>(B) * N;
  Leaves leaves{{d0, d1, d2, d3, d4, d5, d6, d7},
                {s0, s1, s2, s3, s4, s5, s6, s7},
                {b0, b1, b2, b3, b4, b5, b6, b7},
                {}};
  int n = 0, most = 1;
  for (; n < kMaxLeaves && leaves.dst[n] != nullptr; ++n) {
    const int bytes = leaves.row_bytes[n];
    if (bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
    leaves.unit[n] = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8
                     : bytes % 4 == 0 ? 4 : 1;
    most = bytes / leaves.unit[n] > most ? bytes / leaves.unit[n] : most;
  }
  if (nodes == 0 || n == 0) return 0;
  const long long blocks = (nodes * most + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  freeze_kernel<<<dim3(static_cast<unsigned>(blocks), n), kThreads, 0, st>>>(
      flags, leaves, resets, nodes);
  return static_cast<int>(cudaGetLastError());
}
