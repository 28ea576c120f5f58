// Kernel KAC: the Paxos round's protocol telemetry and flight recorder,
// added into the run's accumulators once a round.
//
// Replaces: consensus_tpu/engines/paxos.py paxos_round's telemetry tail
// (K19 tail, lines 253-264) on its flat path, with ops/flight.py
// bucket_counts. Counters, in PAXOS_TELEMETRY order: promises (the sum of
// KY's n_prom over proposers), nacks (the acceptors with both of a
// proposing p's flights delivered, KY's n_pair, less its promises: the
// JAX package's is_prop & prep_del & resp_del & ~prom), accepts (the sum
// of KZ's n_acc, its delivered accepted responses), proposals_decided
// (KZ's decided flags), values_learned (learned after the round and not
// before), then the crash and aggregation tails, which stay 0: the port
// rejects those gates. Histogram rounds_to_learn: r + 1 at each newly
// learned (node, slot), so the round adds values_learned into one bucket
// (bucket 0 holds values <= 0, bucket i in 1..14 holds [2^(i-1), 2^i),
// bucket 15 values >= 2^14).
//
// Bound: bytes. The two [B, N, S] learned masks read once (2 bytes a
// (node, slot)) and four words a proposer: at paxos-10kx10k (B = 1, N =
// S = 10 000) 200 MB, 0.060 ms at 3.35 TB/s. The [N, N] delivery mask is
// not read again: KY and KZ counted its pairs as they walked it.
// Design: one launch, a block per 16 KB of a lane's masks (and, in the
// first blocks of a lane, 256 proposers), the (lane, tile) pairs
// flattened into gridDim.x. Where both masks and the lane size are 16-byte
// aligned a thread reads four 16-byte vectors of each and counts the new
// flags four bytes at a time with __popc (a bool is one byte, 0 or 1);
// otherwise it reads bytes. Counts are summed by warp shuffles, one shared
// atomic a warp per counter, then one global integer atomic a block per
// counter and one into the latency bucket.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;                       // bytes a vector load
constexpr int PER_THREAD = 4;                 // vectors a thread
constexpr int CHUNK = THREADS * PER_THREAD * VEC;
constexpr int BUCKETS = 16;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int COUNTED = 5;
constexpr int K_MIN = 11;

__device__ __forceinline__ int lat_bucket(int32_t v) {
  if (v <= 0) return 0;
  return min(32 - __clz(v), BUCKETS - 1);
}

__device__ __forceinline__ int warp_total(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int new_flags(uint32_t out, uint32_t in) {
  return __popc(out & ~in & 0x01010101u);
}

__global__ void __launch_bounds__(THREADS)
paxos_telemetry_kernel(const int32_t* __restrict__ n_prom,
                       const int32_t* __restrict__ n_pair,
                       const int32_t* __restrict__ n_acc,
                       const int32_t* __restrict__ decided,
                       long long decided_stride,
                       const uint8_t* __restrict__ learned_in,
                       const uint8_t* __restrict__ learned,
                       int* __restrict__ t, int* __restrict__ w,
                       int* __restrict__ lat, int r, int N, long long NS,
                       int K, int window, int n_windows, int tiles,
                       bool vec) {
  __shared__ int s_count[COUNTED];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  if (threadIdx.x < COUNTED) s_count[threadIdx.x] = 0;
  __syncthreads();
  int c[COUNTED] = {0, 0, 0, 0, 0};
  const int p = tile * THREADS + static_cast<int>(threadIdx.x);
  if (p < N) {
    const long long i = static_cast<long long>(b) * N + p;
    const int prom = n_prom[i];
    c[0] = prom;
    c[1] = n_pair[i] - prom;
    c[2] = n_acc[i];
    c[3] = decided[b * decided_stride + p] != 0;
  }
  const long long lane = static_cast<long long>(b) * NS;
  const long long start = static_cast<long long>(tile) * CHUNK;
  if (vec) {
    const uint4* in4 = reinterpret_cast<const uint4*>(learned_in + lane);
    const uint4* out4 = reinterpret_cast<const uint4*>(learned + lane);
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) {
      const long long k =
          start / VEC + u * THREADS + static_cast<long long>(threadIdx.x);
      if (k * VEC < NS) {
        const uint4 a = in4[k], o = out4[k];
        c[4] += new_flags(o.x, a.x) + new_flags(o.y, a.y) +
                new_flags(o.z, a.z) + new_flags(o.w, a.w);
      }
    }
  } else {
    for (int u = 0; u < CHUNK / THREADS; ++u) {
      const long long e = start + u * THREADS + threadIdx.x;
      if (e < NS) c[4] += learned[lane + e] && !learned_in[lane + e];
    }
  }
  for (int k = 0; k < COUNTED; ++k) {
    const int v = warp_total(c[k]);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&s_count[k], v);
  }
  __syncthreads();
  if (threadIdx.x < COUNTED) {
    const int v = s_count[threadIdx.x];
    if (v) {
      atomicAdd(&t[static_cast<long long>(b) * K + threadIdx.x], v);
      if (w != nullptr)
        atomicAdd(&w[(static_cast<long long>(b) * n_windows + window) * K +
                     threadIdx.x],
                  v);
      if (lat != nullptr && threadIdx.x == 4)
        atomicAdd(&lat[static_cast<long long>(b) * BUCKETS +
                       lat_bucket(r + 1)],
                  v);
    }
  }
}

}  // namespace

// decided is KZ's flag row ([B, N] int32, lane stride decided_stride). w
// and lat are null when the flight recorder is off; then window and
// n_windows are unused.
extern "C" int ctt_paxos_telemetry(const int32_t* n_prom,
                                   const int32_t* n_pair,
                                   const int32_t* n_acc,
                                   const int32_t* decided,
                                   const uint8_t* learned_in,
                                   const uint8_t* learned, int* t, int* w,
                                   int* lat, long long decided_stride, int r,
                                   int B, int N, int S, int K, int window,
                                   int n_windows, cudaStream_t st) {
  if (K < K_MIN || (w == nullptr) != (lat == nullptr) ||
      (w != nullptr && (window < 0 || window >= n_windows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const long long NS = static_cast<long long>(N) * S;
  const bool vec = NS % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(learned_in) |
                     reinterpret_cast<uintptr_t>(learned)) % VEC) == 0;
  const long long mask_tiles = (NS + CHUNK - 1) / CHUNK;
  const long long node_tiles = (N + THREADS - 1) / THREADS;
  const long long tiles = mask_tiles > node_tiles ? mask_tiles : node_tiles;
  if (tiles * B > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  paxos_telemetry_kernel<<<static_cast<unsigned>(tiles * B), THREADS, 0,
                           st>>>(
      n_prom, n_pair, n_acc, decided, decided_stride, learned_in, learned, t,
      w, lat, r, N, NS, K, window, n_windows, static_cast<int>(tiles), vec);
  return static_cast<int>(cudaGetLastError());
}
