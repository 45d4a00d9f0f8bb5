// Greedy NMS keep mask for Hopper (sm_90a), hand-written CUDA C++: the
// suppression-bitmask form, in two kernels.
//
// Replaces the TPU kernel dd3d_tpu/ops/pallas_nms.py::_nms_kernel (reached
// through pallas_greedy_nms_batched). Same function: boxes (B, N, 4) f32
// xyxy, sorted by descending score per image with the class offset already
// applied, and valid (B, N); keep (B, N). Box i suppresses a later box j
// when i is still alive and IoU(i, j) > threshold (strict). Invalid boxes
// are never kept and never suppress.
//
// What bounds it on this card: not bytes (10 KB an image at N = 512) nor
// operations (about a million IoU tests at (8, 512), a few µs of f32 work
// spread over the SMs), but the serial chain of the greedy walk: box i's
// fate is known only after every earlier box has had its turn. The first
// port walked that chain with every box in one block and one block barrier
// a box (512 barriers an image, 0.23 ms at (8, 512)). This design takes
// everything that does not depend on the chain off it:
//
// 1. nms_mask_kernel, parallel over pairs: one block of 256 threads for
//    each 64 x 64 tile on or above the diagonal of each image's pair matrix
//    (B x T(T+1)/2 blocks, T = ceil(N/64): 288 at (8, 512)). The block
//    stages its 64 column boxes and their areas in shared memory; four
//    threads own row i = 64 r + t (each tests every fourth column, so the
//    dependent IoU chain a thread runs is 16 tests long) and one writes the
//    row's 64-bit word of the scratch (B, N, T) uint64: bit b is set when
//    j = 64 c + b > i, j < N and IoU(i, j) > threshold. Words left of the
//    diagonal are never written and never read.
// 2. nms_scan_kernel, serial over words, for T <= 32 (N <= 2048, every
//    serving and eval shape of the path): one warp an image and no block
//    barrier. Lane w holds the removed-word w in a register, first set from
//    ~valid (with the bits past N set). The rows
//    of word w (64 rows x T words, contiguous in the scratch) are copied to
//    shared memory with cp.async one word ahead of their use, so no load
//    waits on a decision. For each word w in turn, lane w resolves its 64
//    rows alone: row i is kept when its bit is clear, and then ORs its
//    diagonal word mask[i][w] into the register (a dependent OR a row, no
//    shuffle). Lane w then broadcasts the final word with one shuffle, and
//    every lane w' > w ORs in mask[i][w'] of each kept row i of word w,
//    independently of the others. Last, keep = ~removed, as bools.
// 2'. nms_scan_large_kernel, the same walk for T > 32 (N > 2048: the
//    reference's PRE_NMS_TOPK of 1000 a level gives N = 5000; the sample
//    aggregation past POST_NMS_TOPK 341). One block of 256 threads an image.
//    The removed words live in dynamic shared memory (T x 8 bytes: 632 bytes
//    at N = 5000), not one a lane, and nothing of the mask is staged: rows are
//    read from the scratch where they are used (it stays in L2: 12.6 MB at
//    (8, 5000)). For each word w: thread 0 resolves the 64-row chain from the
//    diagonal words, which warps 2-3 loaded for w while the previous word's
//    ORs ran (the mask never changes, so they can be read ahead); then every
//    thread takes the columns w' > w strided by 256 and ORs in mask[i][w'] of
//    each kept row i, one predicated load a row, all in flight at once. Two
//    block barriers a word. Its limit is T x 8 bytes of shared memory, which
//    passes 227 KB only at N > 1.8 million, where the scratch of one image
//    (N x T x 8 bytes) is already 400 GB: the device memory, not the kernel,
//    bounds N.
//
// Fusing both phases into one block an image would keep the mask in shared
// memory, but at N = 2048 it is 512 KB, more than a block can hold, and it
// would run an image's 131k IoU tests (at N = 512) on one SM instead of
// spreading the 288 tiles over the card; so the two kernels stay. The
// scratch is 256 KB at (8, 512) and stays in L2.
//
// What holds the scan back now: one warp's instruction stream, linear in N
// (about 27 ns a row on an H100, chip_smoke.py phase 5): the owner lane's
// dependent test-and-OR of each row, then the other lanes' OR of each kept
// row. It is a latency floor; no roofline counts it.
//
// A second entry runs the same scan on a suppression matrix the caller has
// already computed, as the rotated BEV NMS does (its IoU is the batched
// polygon clip of ops/rotated_boxes.py, made by PyTorch ops on the card):
// 3. nms_pack_kernel packs a (B, N, N) f32 matrix into the scratch words in
//    the layout nms_mask_kernel writes: one warp a (image, row, word), two
//    ballots of `iou[i][j] > threshold and j > i`, every word of the row
//    (those left of the diagonal come out zero). The caller zeroes the
//    pairs of different classes first, as the JAX package does before its
//    greedy fixpoint (dd3d_tpu/ops/rotated_boxes.py:142-147).
// 4. nms_scan_kernel, unchanged. A comparison is exact, so the keep mask is
//    the plain version's bit for bit.
//
// Same bits as the plain version (dd3d_tpu_torch/ops/nms.py and
// dd3d_tpu/ops/nms.py:22-34): every IoU operation is an explicitly rounded
// IEEE fp32 intrinsic in the same order, and the library is built with
// -fmad=false, because a fused multiply-add flips keep decisions that sit at
// the threshold.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;       // boxes a tile side, bits a word
constexpr int kMaxWords = 32;   // the one-warp scan holds the removed words a lane: N <= 2048
constexpr int kLargeThreads = 256;  // the large scan's block
constexpr int kMaxSharedBytes = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kSplit = 4;       // threads a row in the mask kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void __launch_bounds__(kTile * kSplit) nms_mask_kernel(const float* __restrict__ boxes,
                                                                   uint64_t* __restrict__ mask, int n, int words,
                                                                   float iou_threshold) {
  __shared__ float sx1[kTile], sy1[kTile], sx2[kTile], sy2[kTile], sarea[kTile];
  // blockIdx.x enumerates the tiles (r, c), c >= r, row by row
  int c = blockIdx.x, r = 0;
  while (c >= words - r) {
    c -= words - r;
    ++r;
  }
  c += r;
  const size_t img = blockIdx.y;
  const float* b = boxes + img * n * 4;
  const int t = threadIdx.x;

  const int j = c * kTile + t;
  if (t < kTile && j < n) {
    const float x1 = b[4 * j], y1 = b[4 * j + 1], x2 = b[4 * j + 2], y2 = b[4 * j + 3];
    sx1[t] = x1;
    sy1[t] = y1;
    sx2[t] = x2;
    sy2[t] = y2;
    sarea[t] = box_area(x1, y1, x2, y2);
  }
  __syncthreads();

  // kSplit neighbouring lanes share row i, each testing every kSplit-th
  // column, and OR their bits together with shuffles
  const int row = t / kSplit, part = t % kSplit;
  const int i = r * kTile + row;
  uint64_t bits = 0;
  if (i < n) {
    const float ix1 = b[4 * i], iy1 = b[4 * i + 1], ix2 = b[4 * i + 2], iy2 = b[4 * i + 3];
    const float iarea = box_area(ix1, iy1, ix2, iy2);
    const int cols = min(kTile, n - c * kTile);
    for (int k = part; k < cols; k += kSplit) {
      if (r == c && k <= row) continue;
      const float iw = fmaxf(__fsub_rn(fminf(ix2, sx2[k]), fmaxf(ix1, sx1[k])), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(iy2, sy2[k]), fmaxf(iy1, sy1[k])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(iarea, sarea[k]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
      if (iou > iou_threshold) bits |= 1ull << k;
    }
  }
#pragma unroll
  for (int d = 1; d < kSplit; d *= 2) bits |= __shfl_xor_sync(kFull, bits, d);
  if (i < n && part == 0) mask[(img * n + i) * words + c] = bits;
}

__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// Copies the rows of word w (rows 64w.., all `words` words of each) into
// `dst`; every lane issues its share and commits one group.
__device__ __forceinline__ void stage_rows(uint64_t* dst, const uint64_t* rows, int w, int n, int words, int lane) {
  const int count = min(kTile, n - w * kTile) * words;
  const uint64_t* src = rows + static_cast<size_t>(w) * kTile * words;
  for (int e = lane; e < count; e += 32) cp_async8(dst + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(32) nms_scan_kernel(const uint64_t* __restrict__ mask,
                                                      const unsigned char* __restrict__ valid,
                                                      unsigned char* __restrict__ keep, int n, int words) {
  __shared__ uint64_t buf[2][kTile * kMaxWords];
  const size_t img = blockIdx.x;
  const int lane = threadIdx.x;
  const uint64_t* rows = mask + img * n * words;
  const unsigned char* v = valid + img * n;

  stage_rows(buf[0], rows, 0, n, words, lane);

  // lane w: removed-word w, from ~valid, the bits past N set; every load
  // is issued before the first ballot
  bool gone[2 * kMaxWords];
#pragma unroll
  for (int e = 0; e < 2 * kMaxWords; ++e) {
    const int i = e * 32 + lane;
    gone[e] = i >= n || !v[i];
  }
  uint64_t removed = 0;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const unsigned lo = __ballot_sync(kFull, gone[2 * w]);
    const unsigned hi = __ballot_sync(kFull, gone[2 * w + 1]);
    if (lane == w) removed = (static_cast<uint64_t>(hi) << 32) | lo;
  }

  for (int w = 0; w < words; ++w) {
    if (w + 1 < words) {
      stage_rows(buf[(w + 1) & 1], rows, w + 1, n, words, lane);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();
    const uint64_t* rw = buf[w & 1];
    const int nrows = min(kTile, n - w * kTile);
    if (lane == w) {
      // The chain: a row's bit, then its diagonal word ORed in. Kept in two
      // 32-bit halves with the bit position a constant of the unrolled loop,
      // so a step is a test and a predicated OR; every load is issued
      // whatever the decision (rows past N read stale words of the buffer,
      // never used). Rows 32.. of the word only set bits 33.. (j > i), so
      // their low halves are zero.
      uint32_t lo = static_cast<uint32_t>(removed), hi = static_cast<uint32_t>(removed >> 32);
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint64_t diag = rw[b * words + w];
        if (b < nrows && !(lo & (1u << b))) {
          lo |= static_cast<uint32_t>(diag);
          hi |= static_cast<uint32_t>(diag >> 32);
        }
      }
#pragma unroll
      for (int b = 32; b < kTile; ++b) {
        const uint32_t diag_hi = static_cast<uint32_t>(rw[b * words + w] >> 32);
        if (b < nrows && !(hi & (1u << (b - 32)))) hi |= diag_hi;
      }
      removed = (static_cast<uint64_t>(hi) << 32) | lo;
    }
    const uint64_t kept = ~__shfl_sync(kFull, removed, w);
    if (lane > w && lane < words) {
      // four independent accumulators: no chain of 64 ORs
      uint64_t acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const uint64_t row = rw[b * words + lane];
        if (b < nrows && ((kept >> b) & 1)) acc[b & 3] |= row;
      }
      removed |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
    }
    __syncwarp();  // buf[w & 1] is staged again for word w + 2
  }

  unsigned char* k = keep + img * n;
  for (int w = 0; w < words; ++w) {
    const uint64_t word = __shfl_sync(kFull, removed, w);
    const int i0 = w * kTile + lane, i1 = i0 + 32;
    if (i0 < n) k[i0] = !((word >> lane) & 1);
    if (i1 < n) k[i1] = !((word >> (lane + 32)) & 1);
  }
}

__global__ void __launch_bounds__(kLargeThreads) nms_scan_large_kernel(const uint64_t* __restrict__ mask,
                                                                       const unsigned char* __restrict__ valid,
                                                                       unsigned char* __restrict__ keep, int n,
                                                                       int words) {
  extern __shared__ uint64_t removed[];  // words entries
  __shared__ uint64_t diag[2][kTile];
  __shared__ uint64_t kept_word;
  const size_t img = blockIdx.x;
  const int t = threadIdx.x;
  const uint64_t* rows = mask + img * n * words;
  const unsigned char* v = valid + img * n;

  // removed-word w from ~valid, the bits past N set
  for (int w = t; w < words; w += kLargeThreads) {
    uint64_t word = 0;
    for (int b = 0; b < kTile; ++b) {
      const int i = w * kTile + b;
      if (i >= n || !v[i]) word |= 1ull << b;
    }
    removed[w] = word;
  }
  // the diagonal words of word 0: row b's word 0
  if (t < kTile) diag[0][t] = t < n ? rows[static_cast<size_t>(t) * words] : 0;
  __syncthreads();

  for (int w = 0; w < words; ++w) {
    const int nrows = min(kTile, n - w * kTile);
    if (t == 0) {
      // the chain: a row's bit, then its diagonal word ORed in
      uint64_t r = removed[w];
      const uint64_t* d = diag[w & 1];
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const uint64_t word = d[b];
        if (b < nrows && !((r >> b) & 1)) r |= word;
      }
      removed[w] = r;
      kept_word = ~r & (nrows == kTile ? ~0ull : (1ull << nrows) - 1);
    } else if (t >= 2 * 32 && t < 2 * 32 + kTile && w + 1 < words) {
      // meanwhile, read the next word's diagonal words ahead
      const int b = t - 2 * 32, i = (w + 1) * kTile + b;
      diag[(w + 1) & 1][b] = i < n ? rows[static_cast<size_t>(i) * words + w + 1] : 0;
    }
    __syncthreads();
    const uint64_t kept = kept_word;
    const uint64_t* rw = rows + static_cast<size_t>(w) * kTile * words;
    for (int c = w + 1 + t; c < words; c += kLargeThreads) {
      // four independent accumulators: no chain of 64 ORs
      uint64_t acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        if ((kept >> b) & 1) acc[b & 3] |= rw[static_cast<size_t>(b) * words + c];
      }
      removed[c] |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
    }
    __syncthreads();  // removed[w + 1] is final, and diag[w & 1] may be read again for word w + 2
  }

  unsigned char* k = keep + img * n;
  for (int i = t; i < n; i += kLargeThreads) k[i] = !((removed[i / kTile] >> (i % kTile)) & 1);
}

// Launches the scan of `words` words: the one-warp kernel up to kMaxWords,
// the block kernel past it.
cudaError_t launch_scan(const uint64_t* mask, const unsigned char* valid, unsigned char* keep, int batch, int n,
                        int words, cudaStream_t s) {
  if (words <= kMaxWords) {
    nms_scan_kernel<<<batch, 32, 0, s>>>(mask, valid, keep, n, words);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(words) * sizeof(uint64_t);
  if (smem > kMaxSharedBytes - sizeof(uint64_t) * (2 * kTile + 1)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(nms_scan_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_scan_large_kernel<<<batch, kLargeThreads, smem, s>>>(mask, valid, keep, n, words);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(256) nms_pack_kernel(const float* __restrict__ iou, uint64_t* __restrict__ mask,
                                                       int n, int words, float iou_threshold, long long total) {
  // blockDim.x is a multiple of 32, so a warp returns whole or not at all
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (warp >= total) return;
  const int lane = threadIdx.x % 32;
  const int w = static_cast<int>(warp % words);
  const long long row = warp / words;  // image * n + i
  const int i = static_cast<int>(row % n);
  const float* r = iou + row * n;
  const int j0 = w * kTile + lane, j1 = j0 + 32;
  const bool b0 = j0 < n && j0 > i && r[j0] > iou_threshold;
  const bool b1 = j1 < n && j1 > i && r[j1] > iou_threshold;
  const unsigned lo = __ballot_sync(kFull, b0);
  const unsigned hi = __ballot_sync(kFull, b1);
  if (lane == 0) mask[row * words + w] = (static_cast<uint64_t>(hi) << 32) | lo;
}

}  // namespace

extern "C" {

// Launches the mask kernel and the scan kernel on `stream`, does not
// synchronise; `mask` is scratch of batch * n * ceil(n / 64) uint64 words.
// Returns cudaGetLastError().
int dd3d_nms_keep(const float* boxes, const unsigned char* valid, uint64_t* mask, unsigned char* keep, int batch,
                  int n, float iou_threshold, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, batch), kTile * kSplit, 0, s>>>(boxes, mask, n, words,
                                                                                 iou_threshold);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_scan(mask, valid, keep, batch, n, words, s));
}

// Packs a score-sorted (batch, n, n) f32 suppression matrix `iou` into
// `mask` (batch * n * ceil(n / 64) uint64 words) on `stream`: bit j of row
// i is set when j > i and iou[i][j] > iou_threshold. Does not synchronise.
int dd3d_nms_pack_mask(const float* iou, uint64_t* mask, int batch, int n, float iou_threshold, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  const long long total = static_cast<long long>(batch) * n * words;  // warps
  const int threads = 256;
  const long long blocks = (total * 32 + threads - 1) / threads;
  nms_pack_kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iou, mask, n, words, iou_threshold, total);
  return static_cast<int>(cudaGetLastError());
}

// The greedy walk alone, on a mask packed by dd3d_nms_pack_mask (or written
// by nms_mask_kernel): keep (batch, n) from valid (batch, n), one block an
// image, on `stream`. Does not synchronise.
int dd3d_nms_scan_keep(const uint64_t* mask, const unsigned char* valid, unsigned char* keep, int batch, int n,
                       void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  return static_cast<int>(launch_scan(mask, valid, keep, batch, n, words, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
