// Materialization barrier: an identity copy on Hopper (sm_90a).
//
// Replaces blackman_harris_win_tpu/kernels/pallas/barrier.py:materialize,
// a tile-by-tile Pallas copy that XLA cannot fuse through, which keeps the
// DDC's CORDIC mixer from being recomputed inside the strided conv's
// overlapping tap windows (pipeline/fir.py, bulk branch).  Eager PyTorch
// already materialises the mixer output, so here the kernel is the same
// copy: one read and one write of the array.
//
// What bounds it on the H100: device memory bandwidth.  On the DDC of
// bench_all config 21 it moves a (2, 2^26) float32 array, 512 MB read and
// 512 MB written: at 3.35 TB/s no less than 0.32 ms.
//
// Design: the copy is bytewise in meaning.  Where src = dst (mod 16) (a
// fresh output tensor is 256-byte aligned, so a contiguous input at its own
// allocation start is such a case), the 16-byte-aligned body goes through
// Hopper's bulk-copy engine (materialize_bulk_kernel): a persistent grid of
// two one-warp blocks per SM, in each of which one thread keeps a ring of
// kStages shared-memory stages of 32 KB in flight.  A stage comes in by
// cp.async.bulk (global -> shared, completion counted in bytes on the
// stage's mbarrier) and goes out by cp.async.bulk (shared -> global, a bulk
// group); the stage is loaded again once its store has finished reading
// it.  No thread moves a byte of the body itself, so the copy costs a few
// instructions per stage, and each SM keeps up to 2 x kStages x 32 KB of
// loads and stores in flight.  The ragged head (until src reaches
// 16-byte alignment) and tail (fewer than 16 bytes) are copied bytewise by
// the first block's lanes.
//
// Other offsets take the vector loop (materialize_kernel): the widest V in
// {8, 4, 2, 1} bytes with src = dst (mod V), the ragged head and tail
// bytewise, the aligned body V bytes per thread per step in a grid-stride
// loop that issues four independent loads before their stores.  Nothing
// assumes 16-byte alignment.  Each path runs on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// the bulk ring: bytes per stage (a multiple of 16), stages per block,
// blocks per SM; 2 x 3 x 32 KB of the SM's 228 KB of shared memory.  Other
// geometries (8-64 KB stages, 3-12 stages, 1-4 blocks per SM) were no
// faster on the DDC's 1 GiB copy.
constexpr int kStageBytes = 32768;
constexpr int kStages = 3;
constexpr int kBulkBlocksPerSm = 2;
// loads kept in flight ahead of the newest store
constexpr int kAhead = kStages - 1;
static_assert(kStageBytes % 16 == 0, "bulk copies move 16-byte multiples");

template <typename V>
__global__ void __launch_bounds__(kThreads)
    materialize_kernel(unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
                       i64 head, i64 nvec, i64 tail) {
  const i64 tid = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  if (tid < head) dst[tid] = src[tid];
  const i64 body_end = head + nvec * (i64)sizeof(V);
  if (tid < tail) dst[body_end + tid] = src[body_end + tid];

  V* __restrict__ o = reinterpret_cast<V*>(dst + head);
  const V* __restrict__ s = reinterpret_cast<const V*>(src + head);
  i64 i = tid;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    const V a = s[i], b = s[i + stride], c = s[i + 2 * stride], d = s[i + 3 * stride];
    o[i] = a;
    o[i + stride] = b;
    o[i + 2 * stride] = c;
    o[i + 3 * stride] = d;
  }
  for (; i < nvec; i += stride) o[i] = s[i];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bytes [head, head + nbody) through the bulk-copy ring (nbody a multiple
// of 16, src + head and dst + head 16-byte aligned); the head and tail
// bytes around it by block 0.  Chunk c of kStageBytes goes to block
// c mod gridDim.x.
__global__ void __launch_bounds__(32)
    materialize_bulk_kernel(unsigned char* __restrict__ dst,
                            const unsigned char* __restrict__ src, i64 head, i64 nbody,
                            i64 tail) {
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) dst[t] = src[t];
    if (t < tail) dst[head + nbody + t] = src[head + nbody + t];
  }
  if (threadIdx.x != 0) return;

  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStages];
  const uint32_t ring_s = smem_addr(ring), full_s = smem_addr(full);
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full_s + 8 * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const i64 nchunks = (nbody + kStageBytes - 1) / kStageBytes;
  const i64 b = blockIdx.x, g = gridDim.x;
  const i64 mine = nchunks > b ? (nchunks - 1 - b) / g + 1 : 0;
  auto chunk = [&](i64 j, i64* off, uint32_t* bytes) {
    const i64 c = (b + j * g) * kStageBytes;
    *off = head + c;
    *bytes = (uint32_t)(nbody - c < kStageBytes ? nbody - c : kStageBytes);
  };
  auto load = [&](i64 j) {
    i64 off;
    uint32_t bytes;
    chunk(j, &off, &bytes);
    const uint32_t stage = (uint32_t)(j % kStages);
    const uint32_t bar = full_s + 8 * stage;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(ring_s + stage * kStageBytes),
        "l"(src + off), "r"(bytes), "r"(bar)
        : "memory");
  };

  for (i64 j = 0; j < kAhead && j < mine; ++j) load(j);
  for (i64 j = 0; j < mine; ++j) {
    const uint32_t stage = (uint32_t)(j % kStages);
    wait_parity(full_s + 8 * stage, (uint32_t)((j / kStages) & 1));
    i64 off;
    uint32_t bytes;
    chunk(j, &off, &bytes);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst + off),
        "r"(ring_s + stage * kStageBytes), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (j + kAhead < mine) {
      // the stage of chunk j + kAhead held chunk j - 1: wait until its
      // store (every bulk group but the newest) has read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(j + kAhead);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <typename V>
int launch(unsigned char* dst, const unsigned char* src, i64 nbytes, cudaStream_t stream) {
  const i64 v = (i64)sizeof(V);
  const i64 head = (v - (i64)((uintptr_t)src % v)) % v;
  const i64 h = head < nbytes ? head : nbytes;
  const i64 nvec = (nbytes - h) / v;
  const i64 tail = nbytes - h - nvec * v;
  int sms = 0;
  if (int err = device_sms(&sms)) return err;
  i64 work = nvec > h ? nvec : h;
  if (tail > work) work = tail;
  i64 blocks = (work + kThreads - 1) / kThreads;
  const i64 most = (i64)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  materialize_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(dst, src, h, nvec, tail);
  return (int)cudaGetLastError();
}

int launch_bulk(unsigned char* dst, const unsigned char* src, i64 nbytes, cudaStream_t stream) {
  const i64 head0 = (16 - (i64)((uintptr_t)src % 16)) % 16;
  const i64 head = head0 < nbytes ? head0 : nbytes;
  const i64 nbody = (nbytes - head) & ~(i64)15;
  const i64 tail = nbytes - head - nbody;
  int sms = 0;
  if (int err = device_sms(&sms)) return err;
  const int smem = kStages * kStageBytes;
  // above 48 KB of dynamic shared memory needs an opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !opted_in[dev])) {
    err = cudaFuncSetAttribute(materialize_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && dev < 64) opted_in[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  i64 blocks = (nbody + kStageBytes - 1) / kStageBytes;
  const i64 most = (i64)sms * kBulkBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  materialize_bulk_kernel<<<(unsigned)blocks, 32, smem, stream>>>(dst, src, head, nbody, tail);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bhw_materialize(void* dst, const void* src, i64 nbytes, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
  const uintptr_t diff = (uintptr_t)d ^ (uintptr_t)s;  // low bits where the offsets differ
  cudaStream_t st = (cudaStream_t)stream;
  if ((diff & 15) == 0) return launch_bulk(d, s, nbytes, st);
  if ((diff & 7) == 0) return launch<uint2>(d, s, nbytes, st);
  if ((diff & 3) == 0) return launch<unsigned int>(d, s, nbytes, st);
  if ((diff & 1) == 0) return launch<unsigned short>(d, s, nbytes, st);
  return launch<unsigned char>(d, s, nbytes, st);
}

}  // extern "C"
