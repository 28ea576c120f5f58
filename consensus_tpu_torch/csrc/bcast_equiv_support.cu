// Kernel KAK: under SPEC §7c byzantine equivocation on the §6b broadcast
// PBFT round, each receiver's equivocating support, with the lane's
// population n_real read per lane.
//
// Replaces: consensus_tpu/engines/pbft_bcast.py pbft_bcast_round (K15)
// lines 415-433 (eq_extra), and the same sum of
// consensus_tpu/engines/pbft_sweep.py pbft_bcast_round_padded (K17) lines
// 335-350. Node i of lane b is byzantine when n_real[b] - nb <= i <
// n_real[b]. extra[b, j] counts the byzantine senders i whose broadcast goes
// out this round (bit 0 of the node byte KT wrote), with i != j, on j's
// side while the round's partition is active (bit 1: with it inactive every
// side bit is 0), and whose stance toward j, ctt::equiv_stance(seed, r, i,
// j) on absolute ids, is set. Kernel KU adds it to j's P4 and P5 counts.
// Every stance is a Threefry draw of its own, so nothing is shared between
// terms: the kernel draws no stance for a sender whose bit 0 is clear (its
// broadcast is dropped, or it is down: SPEC §6c clears the bit), none for a
// sender on the other side of an active partition, and none for a receiver
// that is not real on a padded ladder lane (j >= n_real), whose count
// nothing reads: it stays 0.
//
// Bound: operations. A lane and round need one draw for each (broadcasting
// byzantine sender, real receiver of its side, not the sender), at most
// nb * n_real: at pbft-100k-bcast with nb = f = 33 333 that is 3.33e9
// draws a lane, about 119 32-bit operations each, 11.8 ms a lane and round
// at 33.5e12 operations a second. It reads each node byte and writes one
// int32 a node.
// Design: one launch on the stream, after a memset of extra. Grid
// (B * tiles, chunks): block x is lane x / tiles and its THREADS receivers
// from THREADS (x mod tiles) on; block y takes the lane's byzantine senders
// SENDERS (y) on. The block stages its chunk's broadcasting senders in
// shared memory, in one list a side, then each thread walks its receiver's
// side's list, draws each stance, keeps its count in a register and adds
// it to its receiver's with one integer atomic. Threads of both sides in a
// warp walk their lists in step, so a warp makes as many rounds of draws as
// its longer list holds senders.
#include <climits>

#include <cuda_runtime.h>

#include <cstdint>

#include "byz.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SENDERS = 1024;  // byzantine senders a block stages

__global__ void __launch_bounds__(THREADS)
equiv_support_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                     const int32_t* __restrict__ n_real,
                     const uint8_t* __restrict__ bits, int* __restrict__ extra,
                     int nb, int N, int tiles) {
  __shared__ int ids[2][SENDERS];
  __shared__ int len[2];
  const int b = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - b * tiles) * THREADS;
  const int n = n_real[b];
  if (j0 >= n) return;  // no real receiver in the block (uniform)
  const int first = n - nb + static_cast<int>(blockIdx.y) * SENDERS;
  const int last = min(first + SENDERS, n);
  if (threadIdx.x < 2) len[threadIdx.x] = 0;
  __syncthreads();
  const long long nodes = static_cast<long long>(b) * N;
  for (int i = first + static_cast<int>(threadIdx.x); i < last; i += THREADS) {
    const uint8_t bi = bits[nodes + i];
    if (bi & 1) {
      const int side = (bi >> 1) & 1;
      ids[side][atomicAdd(&len[side], 1)] = i;
    }
  }
  __syncthreads();
  const int j = j0 + static_cast<int>(threadIdx.x);
  if (j >= n) return;
  const uint32_t sd = seed[b];
  const int side = (bits[nodes + j] >> 1) & 1;
  const int* list = ids[side];
  const int m = len[side];
  int count = 0;
  for (int k = 0; k < m; ++k) {
    const int i = list[k];
    if (i != j)
      count += ctt::equiv_stance(sd, r, static_cast<uint32_t>(i),
                                 static_cast<uint32_t>(j));
  }
  if (count != 0) atomicAdd(&extra[nodes + j], count);
}

}  // namespace

// extra, [B, N] int32, is zeroed and written here.
extern "C" int ctt_bcast_equiv_support(const uint32_t* seed, uint32_t r,
                                       const int32_t* n_real,
                                       const uint8_t* bits, int* extra,
                                       int nb, int B, int N,
                                       cudaStream_t st) {
  if (nb < 0 || nb > N) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  int err = static_cast<int>(cudaMemsetAsync(
      extra, 0, sizeof(int) * static_cast<size_t>(B) * N, st));
  if (err != 0 || nb == 0) return err;
  const long long tiles = (N + THREADS - 1) / THREADS;
  const long long chunks = (nb + SENDERS - 1) / SENDERS;
  if (tiles * B > INT_MAX || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles * B),
                  static_cast<unsigned>(chunks));
  equiv_support_kernel<<<grid, THREADS, 0, st>>>(
      seed, r, n_real, bits, extra, nb, N, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
