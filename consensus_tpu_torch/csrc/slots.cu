// Kernel KG: the SPEC §3b tracked-leader slot lifecycle, with P3a's
// self-match folded in.
//
// Replaces: consensus_tpu/engines/raft_sparse.py raft_sparse_round lines
// 354-375 (rows follow their leader ids from the old slot set to the new
// one; new entries get fresh election-time rows) and lines 385-388 (a
// tracked leader that appends this round matches itself at its new log
// length).
//
// Bound: bytes. It writes both [B, A, N] u8 rows of every slot and reads
// the two old rows of each carried slot: at most 4 bytes a (slot, node),
// 25.6 MB at the flagship shape (B = 8, A = 8, N = 100 000), about 7.6 us
// at 3.35 TB/s.
// Design: a thread per (slot, node) byte on a (node, sweep * slot) grid.
// Thread 0 of each block finds the slot's source among the old slots (an
// empty old slot compares as N + 1, and an uncarried slot takes slot 0 as
// argmax of an all-false row would, unread), its leader's log length and
// its self-match column, and shares them. Carrying permutes rows, so the
// kernel writes fresh buffers and never updates in place.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int32_t ROLE_L = 2;

__global__ void __launch_bounds__(THREADS)
slots_kernel(const int32_t* __restrict__ new_ids,
             const int32_t* __restrict__ lead_id,
             const uint8_t* __restrict__ match_in,
             const uint8_t* __restrict__ next_in,
             const int32_t* __restrict__ role,
             const int32_t* __restrict__ log_len,
             uint8_t* __restrict__ match_out, uint8_t* __restrict__ next_out,
             int N, int A, int E) {
  __shared__ int s_carried, s_src, s_nid, s_nlen, s_self;
  const int slot = blockIdx.y;  // b * A + a
  const int b = slot / A;
  if (threadIdx.x == 0) {
    const int32_t id = new_ids[slot];
    int src = 0;
    bool same = false;
    for (int q = 0; q < A && !same; ++q) {
      const int32_t old = lead_id[b * A + q];
      if (id == (old >= 0 ? old : N + 1)) {
        same = true;
        src = q;
      }
    }
    const int nid = min(max(id, 0), N - 1);
    const long long node = static_cast<long long>(b) * N + nid;
    const int32_t nlen = log_len[node];
    s_carried = same && id >= 0;
    s_src = b * A + src;
    s_nid = nid;
    s_nlen = nlen;
    s_self = id >= 0 && role[node] == ROLE_L && nlen < E ? nid : -1;
  }
  __syncthreads();
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= N) return;
  uint8_t m, n;
  if (s_carried) {
    const long long src = static_cast<long long>(s_src) * N + j;
    m = match_in[src];
    n = next_in[src];
  } else {
    m = j == s_nid ? static_cast<uint8_t>(s_nlen) : 0;
    n = static_cast<uint8_t>(s_nlen + 1);
  }
  if (j == s_self) m = static_cast<uint8_t>(s_nlen + 1);
  const long long out = static_cast<long long>(slot) * N + j;
  match_out[out] = m;
  next_out[out] = n;
}

}  // namespace

extern "C" int ctt_slots(const int32_t* new_ids, const int32_t* lead_id,
                         const uint8_t* match_in, const uint8_t* next_in,
                         const int32_t* role, const int32_t* log_len,
                         uint8_t* match_out, uint8_t* next_out, int B, int N,
                         int A, int E, cudaStream_t st) {
  if (A < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + THREADS - 1) / THREADS, B * A);
  slots_kernel<<<grid, THREADS, 0, st>>>(new_ids, lead_id, match_in, next_in,
                                         role, log_len, match_out, next_out,
                                         N, A, E);
  return static_cast<int>(cudaGetLastError());
}
