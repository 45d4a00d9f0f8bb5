// Weight gradient of a stride-1 SAME conv for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel dd3d_tpu/ops/pallas_conv.py::_dw_kernel (reached
// through conv_dw_s1_same_pallas and the conv2d_s1_same custom_vjp). Same
// function, in the port's layouts: x (B, H, W, CI) and dy (B, H, W, CO),
// both NHWC-contiguous (channels_last NCHW tensors), bf16 or f32, an odd
// k <= 9, and
//
//     dW[co, ci, dh, dw] = sum_{b,h,w} xpad[b, h+dh, w+dw, ci] * dy[b, h, w, co]
//
// in f32 (OIHW). It is a GEMM-shaped contraction with a tiny output
// (M = k*k*CI rows by N = CO columns: 147 x 16 and 144 x 16 at the DLA-34
// stem) and a huge reduction (P = B*H*W pixels, 3.9 M at batch 8, 384x1280).
//
// What bounds it on this card: at the stem shapes 2*M*N*P is about 18.5
// GFLOP against 150-250 MB of input, so on the CUDA cores (67 TFLOP/s f32)
// the FMAs bound it near 0.28 ms, and the inputs cannot be read faster
// than ~0.06 ms. This first version runs on the CUDA cores. The TPU kernel
// stacked the k*k shifts into the MXU's M dimension; here the same stacking
// is an offset table: each thread owns kMR rows m = (dh, dw, ci) of the
// output and one slice of kNR output channels, and reads its x value of
// pixel q at `tile[q] + off[m]` from a shared-memory halo tile.
//
// Design:
// - Pass 1 (dw_partial_kernel): the pixels are cut into tiles of th x kTW
//   of one image (th = 8, 4, 2 or 1 rows, the most that fits kSmemBudget).
//   A fixed grid of blocks walks the tiles in a fixed order
//   (tile = blockIdx.x + i * gridDim.x). For each tile the block stages the
//   x halo tile and the dy tile in shared memory, widened to f32 (zeros
//   outside the image), and each thread accumulates its kMR x kNR outputs
//   in f32 registers over the pixels of its pixel group. The block then
//   sums its pixel groups in a fixed order through shared memory and
//   writes one partial per block to the workspace.
// - Pass 2 (dw_reduce_kernel): one thread per output sums the blocks'
//   partials in block order and writes dW in OIHW.
// No float atomicAdd anywhere, and the grid depends on the shapes alone,
// so two runs give identical bits. The FMAs are the explicit __fmaf_rn
// (the library is built with -fmad=false for the NMS kernel's sake).
// gridDim.y splits M into slices of kThreads * kMR rows and CO into
// slices of kNR channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMR = 4;    // output rows m per thread
constexpr int kNR = 16;   // output channels per block slice
constexpr int kTW = 32;   // tile width in pixels
constexpr int kBlocksX = 264;  // fixed: two blocks for each of 132 SMs
constexpr int kSmemBudget = 100 * 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Params {
  int b, h, w, ci, co, k;
  int th;        // tile height (8, 4, 2 or 1 rows)
  int tiles_h, tiles_w, ntiles;
  int m;         // k * k * ci
  int co_slices;
};

// Floats of the x halo tile, rounded up to 4 so that the dy tile behind it
// is 16-byte aligned for its float4 reads.
__host__ __device__ __forceinline__ int x_tile_floats(const Params& p) {
  return ((p.th + p.k - 1) * (kTW + p.k - 1) * p.ci + 3) / 4 * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                               float* __restrict__ ws, Params p) {
  extern __shared__ float smem[];
  const int pad = (p.k - 1) / 2;
  const int xw = kTW + p.k - 1;
  const int xh = p.th + p.k - 1;
  const int tp = p.th * kTW;
  float* xs = smem;                      // xh * xw * ci
  float* ys = smem + x_tile_floats(p);   // max(tp, kThreads) * kNR: the dy tile, then the group sums

  const int m_slice = blockIdx.y / p.co_slices;
  const int co0 = (blockIdx.y % p.co_slices) * kNR;
  const int m0 = m_slice * kThreads * kMR;
  const int items = min(kThreads, (p.m - m0 + kMR - 1) / kMR);
  const int groups = kThreads / items;
  const int tid = threadIdx.x;
  const int item = tid % items;
  const int group = tid / items;
  const bool active = group < groups;

  int off[kMR];
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    const int m = m0 + item * kMR + r;
    if (m < p.m) {
      const int tap = m / p.ci, c = m % p.ci;
      off[r] = ((tap / p.k) * xw + tap % p.k) * p.ci + c;
    } else {
      off[r] = 0;  // a padding row: computed and never written
    }
  }

  float acc[kMR][kNR];
#pragma unroll
  for (int r = 0; r < kMR; ++r)
#pragma unroll
    for (int n = 0; n < kNR; ++n) acc[r][n] = 0.0f;

  const int per_image = p.tiles_h * p.tiles_w;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int bi = tile / per_image;
    const int rem = tile % per_image;
    const int h0 = (rem / p.tiles_w) * p.th;
    const int w0 = (rem % p.tiles_w) * kTW;
    __syncthreads();  // the previous tile is consumed
    const size_t img = static_cast<size_t>(bi) * p.h;
    for (int i = tid; i < xh * xw * p.ci; i += kThreads) {
      const int c = i % p.ci;
      const int t = i / p.ci;
      const int gh = h0 - pad + t / xw;
      const int gw = w0 - pad + t % xw;
      float v = 0.0f;
      if (gh >= 0 && gh < p.h && gw >= 0 && gw < p.w) v = widen(x[((img + gh) * p.w + gw) * p.ci + c]);
      xs[i] = v;
    }
    for (int i = tid; i < tp * kNR; i += kThreads) {
      const int n = i % kNR;
      const int q = i / kNR;
      const int gh = h0 + q / kTW;
      const int gw = w0 + q % kTW;
      float v = 0.0f;
      if (gh < p.h && gw < p.w && co0 + n < p.co) v = widen(dy[((img + gh) * p.w + gw) * p.co + co0 + n]);
      ys[i] = v;
    }
    __syncthreads();
    if (active) {
      for (int q = group; q < tp; q += groups) {
        const float* xq = xs + ((q / kTW) * xw + q % kTW) * p.ci;
        const float4* yq = reinterpret_cast<const float4*>(ys + q * kNR);
        float yv[kNR];
#pragma unroll
        for (int j = 0; j < kNR / 4; ++j) {
          const float4 v = yq[j];
          yv[4 * j] = v.x;
          yv[4 * j + 1] = v.y;
          yv[4 * j + 2] = v.z;
          yv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kMR; ++r) {
          const float xv = xq[off[r]];
#pragma unroll
          for (int n = 0; n < kNR; ++n) acc[r][n] = __fmaf_rn(xv, yv[n], acc[r][n]);
        }
      }
    }
  }

  // Sum the pixel groups in group order, one row r at a time, through ys.
  float* ws_block = ws + static_cast<size_t>(blockIdx.x) * p.m * p.co;
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int n = 0; n < kNR; ++n) ys[tid * kNR + n] = acc[r][n];
    }
    __syncthreads();
    const int m = m0 + item * kMR + r;
    if (active && group == 0 && m < p.m) {
      for (int n = 0; n < kNR && co0 + n < p.co; ++n) {
        float s = ys[item * kNR + n];
        for (int g = 1; g < groups; ++g) s += ys[(g * items + item) * kNR + n];
        ws_block[static_cast<size_t>(m) * p.co + co0 + n] = s;
      }
    }
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int blocks, int m_total,
                                 int ci, int co, int k) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;  // OIHW index
  if (o >= m_total * co) return;
  const int dw = o % k;
  const int dh = (o / k) % k;
  const int c = (o / (k * k)) % ci;
  const int n = o / (k * k * ci);
  const size_t idx = static_cast<size_t>((dh * k + dw) * ci + c) * co + n;
  const size_t stride = static_cast<size_t>(m_total) * co;
  float s = 0.0f;
  for (int blk = 0; blk < blocks; ++blk) s += ws[idx + blk * stride];
  out[o] = s;
}

bool make_params(int b, int h, int w, int ci, int co, int k, Params* p, size_t* smem) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || k <= 0 || k > 9 || k % 2 == 0) return false;
  for (int th = 8; th >= 1; th /= 2) {
    const size_t tile = (static_cast<size_t>(th + k - 1) * (kTW + k - 1) * ci + 3) / 4 * 4;
    const size_t rest = static_cast<size_t>(th * kTW > kThreads ? th * kTW : kThreads) * kNR;
    const size_t bytes = (tile + rest) * sizeof(float);
    if (bytes <= kSmemBudget) {
      p->b = b;
      p->h = h;
      p->w = w;
      p->ci = ci;
      p->co = co;
      p->k = k;
      p->th = th;
      p->tiles_h = (h + th - 1) / th;
      p->tiles_w = (w + kTW - 1) / kTW;
      p->ntiles = b * p->tiles_h * p->tiles_w;
      p->m = k * k * ci;
      p->co_slices = (co + kNR - 1) / kNR;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch(const void* x, const void* dy, float* ws, float* out, const Params& p, size_t smem, cudaStream_t stream) {
  const int blocks = p.ntiles < kBlocksX ? p.ntiles : kBlocksX;
  const int m_slices = (p.m + kThreads * kMR - 1) / (kThreads * kMR);
  cudaError_t err = cudaFuncSetAttribute(dw_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_partial_kernel<T><<<dim3(blocks, m_slices * p.co_slices), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = p.m * p.co;
  dw_reduce_kernel<<<(outputs + 255) / 256, 256, 0, stream>>>(ws, out, blocks, p.m, p.ci, p.co, p.k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of workspace dd3d_conv_dw_s1_same needs, or -1 for a shape it does
// not take (even or > 9 kernel, or a halo tile beyond its shared memory).
long long dd3d_conv_dw_workspace(int b, int h, int w, int ci, int co, int k) {
  Params p;
  size_t smem;
  if (!make_params(b, h, w, ci, co, k, &p, &smem)) return -1;
  const long long blocks = p.ntiles < kBlocksX ? p.ntiles : kBlocksX;
  return blocks * p.m * p.co;
}

// dW (CO, CI, k, k) f32 of x (B, H, W, CI) and dy (B, H, W, CO), both
// bf16 (is_bf16 = 1) or f32. Launches two kernels on `stream`, does not
// synchronise; returns a cudaError_t (1, cudaErrorInvalidValue, for a
// shape it does not take).
int dd3d_conv_dw_s1_same(const void* x, const void* dy, int is_bf16, int b, int h, int w, int ci, int co, int k,
                         float* workspace, float* out, void* stream) {
  Params p;
  size_t smem;
  if (!make_params(b, h, w, ci, co, k, &p, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dy, workspace, out, p, smem, s)
                 : launch<float>(x, dy, workspace, out, p, smem, s);
}

}  // extern "C"
