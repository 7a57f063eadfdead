// Chains of K dependent field operations per thread, to measure what one
// field multiply, square or add costs inside a kernel on this card.
//
// Replaces: the Pallas measurement kernel of scripts/bench_pallas_chain.py
// (`make_chain`, launched by `pl.pallas_call` at :45), which runs K = 400
// chained mul, square or add+red over a (20, TILE) block.  Here each thread
// holds one element x and runs y = y * x, y = y^2 or y = reduce(y + x), K
// times, starting from y = x; the output is y in canonical limbs, so the
// result can be held against Python integers mod p.
//
// What bounds it: integer multiplies (100 or 55 32x32->64-bit products per
// operation against 80 bytes in and out per thread).  The launch fills
// every SM to its occupancy limit, so the measured rate is the card's
// sustained rate of field products with the verify kernel's field code
// (fe25519.cuh), the yardstick for that kernel's time.
//
// Without __CUDACC__ the same source builds for the host (a loop over the
// lanes).

#include "fe25519.cuh"

namespace {

enum { OP_MUL = 0, OP_SQUARE = 1, OP_ADD = 2 };

template <int OP>
DEV void chain(fe& y, const fe& x, int k) {
  for (int j = 0; j < k; j++) {
    if (OP == OP_MUL) {
      fe_mul(y, y, x);
    } else if (OP == OP_SQUARE) {
      fe_sq(y, y);
    } else {
      fe_add(y, y, x);  // 2 carried values
      fe_reduce(y, y);
    }
  }
}

template <int OP>
DEV void chain_one(const int32_t* in, int32_t* out, int k) {
  fe x, y;
#pragma unroll
  for (int l = 0; l < 10; l++) x.v[l] = in[l];
  y = x;
  chain<OP>(y, x, k);
  fe_freeze(y, y);
#pragma unroll
  for (int l = 0; l < 10; l++) out[l] = y.v[l];
}

}  // namespace

#if defined(__CUDACC__)

#define CHAIN_THREADS 256

template <int OP>
__global__ void __launch_bounds__(CHAIN_THREADS)
    fe_chain_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                    int k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  chain_one<OP>(in + (size_t)i * 10, out + (size_t)i * 10, k);
}

static const void* chain_kernel(int op) {
  if (op == OP_MUL) return (const void*)fe_chain_kernel<OP_MUL>;
  if (op == OP_SQUARE) return (const void*)fe_chain_kernel<OP_SQUARE>;
  if (op == OP_ADD) return (const void*)fe_chain_kernel<OP_ADD>;
  return nullptr;
}

// op: 0 multiply, 1 square, 2 add + reduce; k: chain length; in, out:
// (n, 10) int32 limbs (in carried, out canonical).  Launches on `stream`,
// does not synchronise; returns cudaGetLastError().
extern "C" int fe_chain_launch(int op, int k, const void* in, void* out, int n,
                               void* stream) {
  if (!chain_kernel(op)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + CHAIN_THREADS - 1) / CHAIN_THREADS;
    const int32_t* src = (const int32_t*)in;
    int32_t* dst = (int32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (op == OP_MUL)
      fe_chain_kernel<OP_MUL><<<blocks, CHAIN_THREADS, 0, st>>>(src, dst, k, n);
    else if (op == OP_SQUARE)
      fe_chain_kernel<OP_SQUARE><<<blocks, CHAIN_THREADS, 0, st>>>(src, dst, k, n);
    else
      fe_chain_kernel<OP_ADD><<<blocks, CHAIN_THREADS, 0, st>>>(src, dst, k, n);
  }
  return (int)cudaGetLastError();
}

// Blocks of `op`'s kernel resident per SM, threads per block, registers
// and local memory bytes per thread.  Returns a CUDA error code.
extern "C" int fe_chain_occupancy(int op, int* blocks_per_sm, int* threads,
                                  int* regs, int* local_bytes) {
  const void* fn = chain_kernel(op);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return (int)e;
  *threads = CHAIN_THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, CHAIN_THREADS, 0);
}

#else  // host build: the same chains as a loop over the lanes

extern "C" int fe_chain_host(int op, int k, const int32_t* in, int32_t* out,
                             int n) {
  for (int i = 0; i < n; i++) {
    const int32_t* src = in + (size_t)i * 10;
    int32_t* dst = out + (size_t)i * 10;
    if (op == OP_MUL)
      chain_one<OP_MUL>(src, dst, k);
    else if (op == OP_SQUARE)
      chain_one<OP_SQUARE>(src, dst, k);
    else if (op == OP_ADD)
      chain_one<OP_ADD>(src, dst, k);
    else
      return 1;
  }
  return 0;
}

#endif
