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
// Design: the copy is bytewise in meaning and vectorised in practice.  The
// widest vector V in {16, 8, 4, 2, 1} bytes with src = dst (mod V) is
// chosen on the host; the ragged head (until src reaches V alignment) and
// tail (fewer than V bytes) are copied bytewise by the first threads, the
// aligned body V bytes per thread per step, in a grid-stride loop that
// issues four independent loads before their stores.  A fresh output
// tensor is 256-byte aligned, so a contiguous input at its own allocation
// start takes the 16-byte path; a view such as x[1:] (a 4-byte offset)
// takes the widest vector its offset allows, and nothing assumes 16-byte
// alignment.  The kernel runs on the stream it is given, allocates
// nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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

template <typename V>
int launch(unsigned char* dst, const unsigned char* src, i64 nbytes, cudaStream_t stream) {
  const i64 v = (i64)sizeof(V);
  const i64 head = (v - (i64)((uintptr_t)src % v)) % v;
  const i64 h = head < nbytes ? head : nbytes;
  const i64 nvec = (nbytes - h) / v;
  const i64 tail = nbytes - h - nvec * v;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  i64 work = nvec > h ? nvec : h;
  if (tail > work) work = tail;
  i64 blocks = (work + kThreads - 1) / kThreads;
  const i64 most = (i64)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  materialize_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(dst, src, h, nvec, tail);
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
  if ((diff & 15) == 0) return launch<uint4>(d, s, nbytes, st);
  if ((diff & 7) == 0) return launch<uint2>(d, s, nbytes, st);
  if ((diff & 3) == 0) return launch<unsigned int>(d, s, nbytes, st);
  if ((diff & 1) == 0) return launch<unsigned short>(d, s, nbytes, st);
  return launch<unsigned char>(d, s, nbytes, st);
}

}  // extern "C"
