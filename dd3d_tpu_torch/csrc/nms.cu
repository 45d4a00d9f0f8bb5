// Greedy NMS keep mask for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel dd3d_tpu/ops/pallas_nms.py::_nms_kernel (reached
// through pallas_greedy_nms_batched). Same function: boxes (B, N, 4) f32
// xyxy, sorted by descending score per image with the class offset already
// applied, and valid (B, N); keep (B, N). Box k suppresses a later box j
// when k is still alive and IoU(k, j) > threshold (strict). Invalid boxes
// are never kept and never suppress.
//
// What bounds it on this card: the walk is N serial steps (box k's fate is
// known only after every earlier box has had its turn), each ending in one
// block barrier, so it is latency-bound, not bound by bytes or FLOPs (at
// N = 512 it reads 10 KB per image). The design keeps that chain as short
// as it can be: one block per image (images run in parallel across SMs),
// every box, its area and its alive flag in shared memory (21 bytes a box,
// 10.5 KB at N = 512), one __syncthreads() per step, and no work at all in
// a step whose box k is already dead. Within a step each thread tests its
// own later boxes j > k. The bitmask form (IoU tiles into 64-bit
// suppression words, then one serial scan over words) is later work.
//
// Same bits as the plain version (dd3d_tpu_torch/ops/nms.py and
// dd3d_tpu/ops/nms.py:22-34): every operation below is an explicitly
// rounded IEEE fp32 intrinsic in the same order, and the library is built
// with -fmad=false, because a fused multiply-add flips keep decisions that
// sit at the threshold.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void nms_keep_kernel(const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
                                unsigned char* __restrict__ keep, int n, float iou_threshold) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  unsigned char* alive = reinterpret_cast<unsigned char*>(area + n);

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float* b = boxes + base * 4;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float bx1 = b[4 * j], by1 = b[4 * j + 1], bx2 = b[4 * j + 2], by2 = b[4 * j + 3];
    x1[j] = bx1;
    y1[j] = by1;
    x2[j] = bx2;
    y2[j] = by2;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(bx2, bx1), 0.0f), fmaxf(__fsub_rn(by2, by1), 0.0f));
    alive[j] = valid[base + j] ? 1 : 0;
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // alive[k] is final here: only boxes j > k are written in step k.
    if (alive[k]) {
      const float kx1 = x1[k], ky1 = y1[k], kx2 = x2[k], ky2 = y2[k], karea = area[k];
      for (int j = k + 1 + threadIdx.x; j < n; j += blockDim.x) {
        if (!alive[j]) continue;
        const float iw = fmaxf(__fsub_rn(fminf(kx2, x2[j]), fmaxf(kx1, x1[j])), 0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(ky2, y2[j]), fmaxf(ky1, y1[j])), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(karea, area[j]), inter);
        const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
        if (iou > iou_threshold) alive[j] = 0;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x) keep[base + j] = alive[j];
}

}  // namespace

extern "C" {

// Largest N the kernel takes: 21 bytes a box must fit the 48 KB of shared
// memory a block gets without opting in to more.
int dd3d_nms_max_n() { return 2048; }

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int dd3d_nms_keep(const float* boxes, const unsigned char* valid, unsigned char* keep, int batch, int n,
                  float iou_threshold, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = static_cast<size_t>(n) * (5 * sizeof(float) + 1);
  nms_keep_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(boxes, valid, keep, n,
                                                                                iou_threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
