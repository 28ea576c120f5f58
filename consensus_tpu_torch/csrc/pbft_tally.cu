// Kernel KR: SPEC §6 P4 prepare tally and P5 commit tally of the dense PBFT
// round at every (node, slot) of each lane, with the lane's population
// n_real and quorum 2f + 1 read per lane.
//
// Replaces: consensus_tpu/engines/pbft.py pbft_round (K16) lines 308-342 on
// its flat path and the same phases of consensus_tpu/engines/pbft_sweep.py
// pbft_round_padded (K17) lines 251-268: for each receiver j and slot s,
// count the real senders i, delivered to j or j itself, whose flag at s is
// set and whose pp_val at s equals j's. P4 with the flag pp_seen: a seen
// slot whose count reaches 2f + 1 is prepared. P5 with the flag prepared
// as P4 left it: a prepared, uncommitted slot whose count reaches 2f + 1
// is committed, and its pp_val becomes its decided value. The JAX round
// materialises the [N, N, S] value match; this kernel does not.
//
// Bound: operations, where quorums are open. A count costs about three
// operations a (sender, receiver, slot) triple, and only the slots that
// wait on a quorum need one (seen and unprepared in P4, prepared and
// uncommitted in P5), over the lane's real senders only. Bytes: each
// phase reads the flags and values of every slot and writes its outputs,
// 13 bytes a (node, slot), and the real part of the delivery mask.
// Design: one kernel, launched for P4 and again for P5 (P5 reads every
// sender's post-P4 prepared flag). A block of 32 x 8 threads holds 32
// slots of 8 receivers of one lane; the (lane, tile) pairs are flattened
// into gridDim.x, so the lane count has no grid limit of its own. When
// one of them waits on a quorum, the block walks the lane's real senders
// 32 at a time: it stages their values and flags at its 32 slots and
// their delivery bytes to its 8 receivers in shared memory, and each
// waiting thread adds its matches. A block whose slots wait on nothing
// skips the walk. Every (node, slot) is written.
// Its BYZ instances (SPEC §3c/§6, picked with byzantine nodes: node i of a
// lane is honest when i < n_real - nb) walk the honest senders only, j
// itself included only when honest, in both modes (pbft.py:172-173,
// 309-316). The equivocate instance first launches a warp per (lane,
// receiver) that counts extra[j], the byzantine real senders i delivered
// to j (deliver[i, j]; the mask's diagonal is empty) whose stance toward j
// (ctt::equiv_stance, absolute ids) is set: they claim j's value at every
// slot, so both tallies add extra[j] to every count (lines 317-320,
// 337-339). Its cost is a draw a delivered (byzantine sender, receiver)
// pair, once a round; a first version with a thread a receiver, each
// drawing nb stances in turn, took 52 us at pbft-f128 (nb = 128).
#include <cuda_runtime.h>

#include <cstdint>

#include "byz.cuh"

namespace {

constexpr int SLOTS = 32;     // slots a block (threadIdx.x)
constexpr int RECEIVERS = 8;  // receivers a block (threadIdx.y)
constexpr int SENDERS = 32;   // senders staged at once
constexpr int THREADS = SLOTS * RECEIVERS;
constexpr int WARPS = THREADS / 32;
static_assert(SENDERS * RECEIVERS == THREADS, "one delivery byte a thread");

// The equivocate instances' first launch: a warp per (lane, receiver),
// flattened; its lanes stride over the lane's byzantine senders and their
// counts are summed by a warp reduction.
__global__ void __launch_bounds__(THREADS)
pbft_extra_kernel(const uint32_t* __restrict__ seed, uint32_t r,
                  const bool* __restrict__ deliver,
                  const int32_t* __restrict__ n_real,
                  int32_t* __restrict__ extra, int N, int nb,
                  long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform in the warp
  const int b = static_cast<int>(row / N);
  const int j = static_cast<int>(row - static_cast<long long>(b) * N);
  const long long nodes = static_cast<long long>(b) * N;
  const int n = n_real[b];
  const uint32_t sd = seed[b];
  int count = 0;
  if (j < n) {
    for (int i = max(n - nb, 0) + lane; i < n; i += 32)
      count += deliver[(nodes + i) * N + j] &&
               ctt::equiv_stance(sd, r, static_cast<uint32_t>(i),
                                 static_cast<uint32_t>(j));
  }
  count = __reduce_add_sync(0xFFFFFFFFu, count);
  if (lane == 0) extra[row] = count;
}

// COMMIT false: P4, flag = pp_seen, writes prepared. COMMIT true: P5,
// flag = prepared (post-P4), writes committed and dval. HONEST: the BYZ
// instances' sender walk (honest senders); extra is non-null in the
// equivocate ones.
template <bool COMMIT, bool HONEST>
__global__ void __launch_bounds__(THREADS)
pbft_tally_kernel(const bool* __restrict__ deliver,
                  const int32_t* __restrict__ n_real,
                  const int32_t* __restrict__ f,
                  const int32_t* __restrict__ pp_val,
                  const bool* __restrict__ pp_seen,
                  const bool* __restrict__ flag,
                  const bool* __restrict__ prepared,
                  const bool* __restrict__ committed,
                  const int32_t* __restrict__ dval,
                  bool* __restrict__ out_flag,
                  int32_t* __restrict__ dval_out, int N, int S,
                  int slot_tiles, int tiles, int nb,
                  const int32_t* __restrict__ extra) {
  __shared__ int32_t s_val[SENDERS][SLOTS];
  __shared__ bool s_flag[SENDERS][SLOTS];
  __shared__ bool s_del[SENDERS][RECEIVERS];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int jt = tile / slot_tiles;
  const int st = tile - jt * slot_tiles;
  const int j0 = jt * RECEIVERS, s0 = st * SLOTS;
  const int j = j0 + threadIdx.y, s = s0 + threadIdx.x;
  const int tid = threadIdx.y * SLOTS + threadIdx.x;
  const bool in = j < N && s < S;
  const long long nodes = static_cast<long long>(b) * N;
  const long long js = in ? (nodes + j) * S + s : 0;
  const int n = n_real[b];
  // The senders counted: the real ones, the honest ones (HONEST).
  const int ns = HONEST ? n - nb : n;
  const int q = 2 * f[b] + 1;
  // Whether this (j, s) waits on a quorum.
  const bool prep = in && prepared[js];
  const bool wait = COMMIT ? in && prep && !committed[js]
                           : in && pp_seen[js] && !prep;
  const int32_t mine = in ? pp_val[js] : 0;
  int count = HONEST && extra != nullptr && in ? extra[nodes + j] : 0;
  if (__syncthreads_or(wait)) {
    for (int i0 = 0; i0 < ns; i0 += SENDERS) {
      for (int e = tid; e < SENDERS * SLOTS; e += THREADS) {
        const int ii = e / SLOTS, ss = e - ii * SLOTS;
        const int i = i0 + ii, sg = s0 + ss;
        const bool ok = i < ns && sg < S;
        const long long is = (nodes + i) * S + sg;
        s_val[ii][ss] = ok ? pp_val[is] : 0;
        s_flag[ii][ss] = ok && flag[is];
      }
      {
        const int ii = tid / RECEIVERS, jj = tid - ii * RECEIVERS;
        const int i = i0 + ii, jg = j0 + jj;
        s_del[ii][jj] = i < ns && jg < n &&
                        (i == jg || deliver[(nodes + i) * N + jg]);
      }
      __syncthreads();
      if (wait) {
        const int lim = min(SENDERS, ns - i0);
        for (int ii = 0; ii < lim; ++ii)
          count += s_del[ii][threadIdx.y] & s_flag[ii][threadIdx.x] &
                   (s_val[ii][threadIdx.x] == mine);
      }
      __syncthreads();
    }
  }
  if (!in) return;
  const bool hit = wait && count >= q;
  if (COMMIT) {
    out_flag[js] = committed[js] || hit;
    dval_out[js] = hit ? mine : dval[js];
  } else {
    out_flag[js] = prep || hit;
  }
}

}  // namespace

extern "C" int ctt_pbft_tally(const bool* deliver, const int32_t* n_real,
                              const int32_t* f, const bool* pp_seen,
                              const int32_t* pp_val, const bool* prepared,
                              const bool* committed, const int32_t* dval,
                              bool* prep_out, bool* com_out,
                              int32_t* dval_out, int B, int N, int S,
                              int byz, int nb, const uint32_t* seed,
                              uint32_t r, int32_t* extra, cudaStream_t st) {
  if (nb < 0 || nb > N || byz < ctt::BYZ_NONE || byz > ctt::BYZ_EQUIV ||
      (byz == ctt::BYZ_EQUIV) != (extra != nullptr) ||
      (extra != nullptr && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0 || S == 0) return 0;
  const int slot_tiles = (S + SLOTS - 1) / SLOTS;
  const long long tiles =
      static_cast<long long>((N + RECEIVERS - 1) / RECEIVERS) * slot_tiles;
  if (tiles * B > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tiles * B);
  const dim3 block(SLOTS, RECEIVERS);
  int err;
  if (extra != nullptr) {
    const long long rows = static_cast<long long>(B) * N;
    pbft_extra_kernel<<<static_cast<unsigned>((rows + WARPS - 1) / WARPS),
                        THREADS, 0, st>>>(seed, r, deliver, n_real, extra, N,
                                          nb, rows);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  const bool honest = byz != ctt::BYZ_NONE;
  // P4: prepared_out = prepared | (pp_seen & count(pp_seen) >= q).
  const auto p4 = honest ? pbft_tally_kernel<false, true>
                         : pbft_tally_kernel<false, false>;
  p4<<<grid, block, 0, st>>>(
      deliver, n_real, f, pp_val, pp_seen, pp_seen, prepared, committed,
      dval, prep_out, nullptr, N, S, slot_tiles,
      static_cast<int>(tiles), nb, extra);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  // P5 over the post-P4 prepared flags.
  const auto p5 = honest ? pbft_tally_kernel<true, true>
                         : pbft_tally_kernel<true, false>;
  p5<<<grid, block, 0, st>>>(
      deliver, n_real, f, pp_val, pp_seen, prep_out, prep_out, committed,
      dval, com_out, dval_out, N, S, slot_tiles,
      static_cast<int>(tiles), nb, extra);
  return static_cast<int>(cudaGetLastError());
}
