// Kernel KA: Threefry-2x32 draws over a [B, M] grid with per-sweep seeds.
//
// Replaces: consensus_tpu/core/rng.py threefry2x32_jnp / random_u32_jnp as
// the JAX package calls them through ops/adversary.py draw(): the election
// timeouts of engines/raft.py _draw_timeout (init, P1 and every term bump),
// the STREAM_VALUE proposal values (P3a) and the STREAM_CHURN draw (P0).
//
// Bound: bytes and operations nearly even. A draw is ~119 32-bit integer
// operations (20 rounds of add, 3-op rotate and xor, plus the key schedule)
// for 4-12 bytes read and 8 written (the draw as int64, the port's u32
// representation): ~3.6 ps of integer issue against ~3.7 ps of HBM a draw.
// Design: one thread per draw on a 2-D grid (m, sweep), the whole Threefry
// schedule unrolled in registers; each of ctx/c0/c1 is either a scalar or an
// int32 tensor of shape [M] (batch stride 0) or [B, M], read once.
#include <cuda_runtime.h>

#include "rng.cuh"

namespace {

struct Operand {
  const int32_t* ptr;
  uint32_t scalar;
  long long bstride;
  __device__ __forceinline__ uint32_t at(int b, long long m) const {
    return ptr ? static_cast<uint32_t>(ptr[b * bstride + m]) : scalar;
  }
};

__global__ void random_u32_kernel(const uint32_t* __restrict__ seed,
                                  uint32_t stream, Operand ctx, Operand c0,
                                  Operand c1, int64_t* __restrict__ out,
                                  long long M) {
  const long long m =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (m >= M) return;
  const int b = blockIdx.y;
  out[b * M + m] = ctt::random_u32(seed[b], stream, ctx.at(b, m), c0.at(b, m),
                                   c1.at(b, m));
}

}  // namespace

extern "C" int ctt_random_u32(const uint32_t* seed, uint32_t stream,
                              const int32_t* ctx, uint32_t ctx_s,
                              long long ctx_bs, const int32_t* c0,
                              uint32_t c0_s, long long c0_bs,
                              const int32_t* c1, uint32_t c1_s,
                              long long c1_bs, int64_t* out, int B,
                              long long M, cudaStream_t st) {
  if (B == 0 || M == 0) return 0;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((M + threads - 1) / threads), B);
  random_u32_kernel<<<grid, threads, 0, st>>>(
      seed, stream, Operand{ctx, ctx_s, ctx_bs}, Operand{c0, c0_s, c0_bs},
      Operand{c1, c1_s, c1_bs}, out, M);
  return static_cast<int>(cudaGetLastError());
}
