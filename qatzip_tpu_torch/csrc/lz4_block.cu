// LZ4 / LZ4s block-decode kernel (Hopper, sm_90a).
//
// Replaces the XLA decoder of qatzip_tpu/ops/lz4_decode.py:42
// (_decode_blocks_impl), ported as plain torch in
// qatzip_tpu_torch/ops/lz4_decode.py (_decode_blocks_impl).  The TPU cannot
// chase a pointer a lane, so that design parses a sequence at every byte of
// a block, walks the chain by pointer doubling and resolves every output
// byte by log-doubling a source pointer: some 2.4 GB of tables for a group
// of 128 blocks.  Here a CTA decodes a block by walking its sequences
// (csrc/lz4_block.cuh); a launch takes every block of a request.
//
// What bounds it on this card: latency, not bytes.  A request moves a few
// tens of MB, some microseconds at the HBM rate, but a block is a chain of
// dependent sequence headers, and a launch lasts as long as its block with
// the most sequences.  The design keeps that chain short:
//  * the input and the match sources are in shared memory: a header byte
//    costs a shared-memory load (~33 clocks) instead of an L2 one, and a
//    match reads the 64 KB window instead of the output the CTA wrote a
//    moment before through L2;
//  * the headers are parsed ahead of the copies, by a warp of their own,
//    so a sequence costs its header's loads or its copies, not both;
//  * one launch a request: every CTA is resident from the start.
// Occupancy: 64 KB of window, a 4 KB input ring and two slots of 64
// sequence records, 71,744 bytes of shared memory a CTA (plus the 1 KB the
// runtime keeps), so 3 CTAs fit in an SM's 228 KB: 396 blocks at once on
// 132 SMs.  Staging a whole block (up to 128 KB) with the window would fit
// 1, and a block wider than the ring is rare: only its long literal runs
// and the headers after them are read from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lz4_block.cuh"

#define QZ_LZ4_THREADS (2 * QZ_LZ4_LANES)   // the parse warp, the copy warp
#define QZ_LZ4_MIN_CTAS 3                   // resident a SM, by shared memory

// A lane's view of its warp, for lz4_block.cuh.
struct QzWarp {
  int lane;
  static constexpr bool kCheck = false;   // no hooks to feed
  template <class T>
  struct Reg {   // a value of the lane's own
    T v;
    __device__ T& operator[](int) { return v; }
  };
  template <class F>
  __device__ void each(F f) { f(lane); }
  // lane src's value of r, and r := v in lane dst (src, dst uniform)
  template <class T>
  __device__ T shfl(Reg<T>& r, int src) {
    return __shfl_sync(0xFFFFFFFFu, r.v, src);
  }
  template <class T>
  __device__ void set(Reg<T>& r, int dst, T v) {
    if (lane == dst) r.v = v;
  }
  __device__ void sync() { __syncwarp(); }
  template <class F>
  __device__ uint32_t ballot(F f) {
    return __ballot_sync(0xFFFFFFFFu, f(lane));
  }
  __device__ void seen_input(int, int, bool) {}
  __device__ void seen_window(int, int) {}
  // bytes (1-16) of src into shared memory at sm + off, the rest of the 16
  // zero-filled; nothing past src + bytes is read
  __device__ void stage(const QzLz4Shm& sm, int off, const uint8_t* src,
                        int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     (uint32_t)sm.at + off),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
  __device__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// A thread's roles in the CTA: warp 0 parses, warp 1 copies.
struct QzCta {
  QzWarp pw, cw;
  int warp;
  __device__ bool parse() const { return warp == 0; }
  __device__ bool copy() const { return warp == 1; }
  __device__ bool lead() const { return threadIdx.x == 0; }
  __device__ void sync() { __syncthreads(); }
  __device__ void landed() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

__global__ void __launch_bounds__(QZ_LZ4_THREADS, QZ_LZ4_MIN_CTAS)
qz_lz4_kernel(QzLz4Args a) {
  extern __shared__ __align__(16) uint8_t qz_lz4_shared[];
  const QzLz4Shm sm = {(uint64_t)__cvta_generic_to_shared(qz_lz4_shared)};
  const int lane = threadIdx.x % QZ_LZ4_LANES;
  QzCta c{{lane}, {lane}, (int)threadIdx.x / QZ_LZ4_LANES};
  qz_lz4_block(a, blockIdx.x, sm, c);
}

static int qz_lz4_prepare() {
  static int rc = -1;
  if (rc < 0)
    rc = (int)cudaFuncSetAttribute(
        qz_lz4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(QzLz4Smem));
  return rc;
}

extern "C" int qz_lz4_decode(const void* in, const void* len, void* out,
                             void* tot, void* err, int rows, int n,
                             int outcap, int lz4s, int base, void* stream) {
  const int rc = qz_lz4_prepare();
  if (rc != 0) return rc;
  const QzLz4Args a = {(const uint8_t*)in, (const int32_t*)len, rows, n,
                       outcap, lz4s, base, (uint8_t*)out, (int32_t*)tot,
                       (uint8_t*)err};
  qz_lz4_kernel<<<rows, QZ_LZ4_THREADS, sizeof(QzLz4Smem),
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch shape: info[0] threads a CTA, info[1] its shared-memory
// bytes, info[2] CTAs resident a SM on the current card, info[3] its SMs.
extern "C" int qz_lz4_info(int* info) {
  int rc = qz_lz4_prepare();
  if (rc != 0) return rc;
  int dev = 0, ctas = 0, sms = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, qz_lz4_kernel, QZ_LZ4_THREADS, sizeof(QzLz4Smem));
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  info[0] = QZ_LZ4_THREADS;
  info[1] = (int)sizeof(QzLz4Smem);
  info[2] = ctas;
  info[3] = sms;
  return rc;
}
