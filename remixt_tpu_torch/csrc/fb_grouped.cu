// Chain-batched, log-space HMM forward-backward for a wave of restarts.
//
// Replaces the TPU kernel _fb_kernel_grouped (remixt_tpu/ops/fb_pallas.py:744)
// and computes what forward_backward_chains_pallas_grouped computes
// (fb_pallas.py:1159), laid out for a GPU rather than copied block by block:
// no one-hot class plane, no flat junction schedule, no DMA ring, no
// junction-major bank transpose, no padding of states or lanes.
//
// Work split: one thread block per (restart r, chain q, direction). The
// block walks the chain's L positions in a loop, keeping the log-space
// carry and the shifted linear vector u = exp(carry - max) in shared
// memory. Each step is
//   cut class (bank index 0):  s = sum(u), the same for every state;
//   any other step:            s = u . M (forward) or M . u (reverse), with M
//                              the lane's static class matrix or its
//                              restart's breakend matrix be_exp[r, j];
//   result = log(max(s, TINY)) + max, plus the frame in the forward direction.
// The reverse direction adds the frame before taking the max (the TPU
// kernel's order), and both directions run through the pad positions
// after a chain's end (cut steps with zero frames), so the betas carry the
// same per-chain constant shift as the reference.
//
// Forward matvec: threads over columns j, so a warp reads a contiguous row
// segment of M. Reverse matvec: a warp per row i with a shuffle reduction,
// again reading rows contiguously.
//
// What bounds it on an H100: the breakend matrices. A whole-genome wave
// (R=8, J<=600, S=355) holds R*J*S*S*4 B ~ 2.4 GB of them. The bound reads
// the bank once, with the frames, static bank, schedule and outputs: 2.63
// GB, 0.785 ms at 3.35 TB/s. Once, because the function needs each matrix
// only once; running both directions off one read is a matter of design,
// not of the function. This design reads the bank once per direction (4.8
// GB, a floor of ~1.5 ms of its own) and, at ~10.4 ms, reaches 7.5 % of the
// bound (chip_smoke.py, H100 80GB HBM3, 700 W).
// The fp32 work is ~2*R*Q*L*S^2 ~ 12 G multiply-adds. The static class
// matrices (at most 5 x 504 KB) stay in L2 but are re-read by every block
// on every step, so this simple design is L2-bandwidth bound well above
// both figures. Running all R restarts of a chain in one block as one
// (R x S).(S x S) product would cut the static re-reads R-fold; that is
// later work.
//
// The scaled-linear variant, fb_grouped_scaled_kernel, replaces the TPU
// kernel _fb_kernel_grouped_scaled (fb_pallas.py:911), the chain update of
// the batched fit under REMIXT_TPU_SCALED_LINEAR=1. Same grid and layout;
// it reads fexp = exp(frame - fmax) (R, Q, L, S) and fmax (R, Q, L), made
// by the wrapper, and keeps the linear carry u in shared memory with one
// float of log scale per block. Each step is
//   s = (u . M) * fexp[t] forward, s = M . (u * fexp[t]) reverse (the cut
//   class sums), m = max(max(s), TINY), u = s / m, scale += log(m) + fmax[t],
// and writes log(max(u, TINY)) + scale: the per-state expf/logf of the
// carry become a block max and a multiply; the output's logf stays. Only
// the output is floored, so states far below a lane's maximum differ from
// the log-space kernel, which it matches within 60 nats of the row maximum.
// Its bound at whole-genome width is the log-space one: fexp and fmax
// replace the frames (0.2 MB more), 2.63 GB moved once, 0.785 ms at
// 3.35 TB/s, above the fp32 24.4 GFLOP (0.364 ms at 67 TFLOP/s). It took
// 8.49 ms, the frame shift in torch (0.15 ms) included, against 10.26 ms
// for fb_grouped_kernel in the same run (chip_smoke.py phase 2c, NVIDIA
// H100 80GB HBM3, 700 W): the same reads, without the expf per state.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float TINY = 1e-37f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; red holds 33 floats of shared memory. Every
// thread of the block must call them. They end with a barrier so red can
// be reused by the next reduction.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nwarps ? red[lane] : -INFINITY;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nwarps ? red[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

// u . M for the block's shared vector u, threads over the output columns
// j (a warp reads a contiguous row segment of M): epi(j, s) per column.
template <typename Epi>
__device__ __forceinline__ void product_forward(const float* M,
                                                const float* u, int S,
                                                Epi epi) {
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float* col = M + j;
    int i = 0;
    for (; i + 3 < S; i += 4) {
      a0 = fmaf(u[i], col[(size_t)i * S], a0);
      a1 = fmaf(u[i + 1], col[(size_t)(i + 1) * S], a1);
      a2 = fmaf(u[i + 2], col[(size_t)(i + 2) * S], a2);
      a3 = fmaf(u[i + 3], col[(size_t)(i + 3) * S], a3);
    }
    for (; i < S; ++i) a0 = fmaf(u[i], col[(size_t)i * S], a0);
    epi(j, (a0 + a1) + (a2 + a3));
  }
}

// M . u, a warp per row i with a shuffle reduction (rows read
// contiguously): lane 0 calls epi(i, s).
template <typename Epi>
__device__ __forceinline__ void product_reverse(const float* M,
                                                const float* u, int S,
                                                Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < S; i += nwarps) {
    const float* row = M + (size_t)i * S;
    float s = 0.f;
    for (int j = lane; j < S; j += 32) s = fmaf(row[j], u[j], s);
    s = warp_sum(s);
    if (lane == 0) epi(i, s);
  }
}

// frames (R, Q, L, S); static_exp (num_static, S, S); be_exp (R, J, S, S);
// cbi (Q, Lm1) int32, value < num_static a static class, num_static + j
// breakend j; alphas, betas (R, Q, L, S). Grid (R*Q, 2), blockDim a
// multiple of 32.
__global__ void fb_grouped_kernel(const float* __restrict__ frames,
                                  const float* __restrict__ static_exp,
                                  const float* __restrict__ be_exp,
                                  const int* __restrict__ cbi,
                                  float* __restrict__ alphas,
                                  float* __restrict__ betas,
                                  int Q, int L, int S, int Lm1,
                                  int num_static, int J) {
  extern __shared__ float smem[];
  float* carry = smem;
  float* u = smem + S;
  float* red = smem + 2 * S;

  const int lane_id = blockIdx.x;  // r * Q + q
  const int r = lane_id / Q;
  const int q = lane_id % Q;
  const bool reverse = blockIdx.y == 1;
  const size_t SS = (size_t)S * S;
  const float* F = frames + (size_t)lane_id * L * S;
  float* out = (reverse ? betas : alphas) + (size_t)lane_id * L * S;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;

  if (!reverse) {
    for (int i = tid; i < S; i += nt) {
      const float f = F[i];
      carry[i] = f;
      out[i] = f;
    }
  } else {
    for (int i = tid; i < S; i += nt) {
      carry[i] = 0.f;
      out[(size_t)(L - 1) * S + i] = 0.f;
    }
  }

  for (int step = 1; step < L; ++step) {
    // forward: pair (t-1, t) produces position t from frame t;
    // reverse: pair (t-1, t) produces position t-1 from frame t
    const int t = reverse ? L - step : step;
    const float* frow = F + (size_t)t * S;
    float* dst = out + (size_t)(reverse ? t - 1 : t) * S;
    __syncthreads();
    if (reverse) {
      for (int i = tid; i < S; i += nt) carry[i] += frow[i];
      __syncthreads();
    }
    float m = -INFINITY;
    for (int i = tid; i < S; i += nt) m = fmaxf(m, carry[i]);
    m = block_max(m, red);
    for (int i = tid; i < S; i += nt) u[i] = expf(carry[i] - m);
    __syncthreads();

    const int b = bidx[t - 1];
    if (b == 0) {
      float s = 0.f;
      for (int i = tid; i < S; i += nt) s += u[i];
      s = block_sum(s, red);
      const float val = logf(fmaxf(s, TINY)) + m;
      for (int j = tid; j < S; j += nt) {
        const float v = reverse ? val : val + frow[j];
        carry[j] = v;
        dst[j] = v;
      }
      continue;
    }
    const float* M = b < num_static
        ? static_exp + (size_t)b * SS
        : be_exp + ((size_t)r * J + (size_t)(b - num_static)) * SS;
    if (!reverse) {
      product_forward(M, u, S, [&](int j, float s) {
        const float v = logf(fmaxf(s, TINY)) + m + frow[j];
        carry[j] = v;
        dst[j] = v;
      });
    } else {
      product_reverse(M, u, S, [&](int i, float s) {
        const float v = logf(fmaxf(s, TINY)) + m;
        carry[i] = v;
        dst[i] = v;
      });
    }
  }
}

// The scaled-linear kernel: fexp (R, Q, L, S) = exp(frame - fmax), fmax
// (R, Q, L); everything else as fb_grouped_kernel.
__global__ void fb_grouped_scaled_kernel(const float* __restrict__ fexp,
                                         const float* __restrict__ fmax,
                                         const float* __restrict__ static_exp,
                                         const float* __restrict__ be_exp,
                                         const int* __restrict__ cbi,
                                         float* __restrict__ alphas,
                                         float* __restrict__ betas,
                                         int Q, int L, int S, int Lm1,
                                         int num_static, int J) {
  extern __shared__ float smem[];
  float* u = smem;           // the linear carry
  float* s = smem + S;       // the step's product, before normalising
  float* red = smem + 2 * S;

  const int lane_id = blockIdx.x;  // r * Q + q
  const int r = lane_id / Q;
  const int q = lane_id % Q;
  const bool reverse = blockIdx.y == 1;
  const size_t SS = (size_t)S * S;
  const float* E = fexp + (size_t)lane_id * L * S;
  const float* FM = fmax + (size_t)lane_id * L;
  float* out = (reverse ? betas : alphas) + (size_t)lane_id * L * S;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;

  // forward starts from u = fexp[0] at scale fmax[0]; reverse from u = 1
  // at scale 0, whose message is 0
  float scale = reverse ? 0.f : FM[0];
  for (int i = tid; i < S; i += nt) {
    if (!reverse) {
      const float e = E[i];
      u[i] = e;
      out[i] = logf(fmaxf(e, TINY)) + scale;
    } else {
      u[i] = 1.f;
      out[(size_t)(L - 1) * S + i] = 0.f;
    }
  }

  for (int step = 1; step < L; ++step) {
    const int t = reverse ? L - step : step;
    const float* erow = E + (size_t)t * S;
    float* dst = out + (size_t)(reverse ? t - 1 : t) * S;
    __syncthreads();
    if (reverse) {
      for (int i = tid; i < S; i += nt) u[i] *= erow[i];
      __syncthreads();
    }
    float m = 0.f;  // the products of non-negative weights are >= 0
    const int b = bidx[t - 1];
    if (b == 0) {
      float total = 0.f;
      for (int i = tid; i < S; i += nt) total += u[i];
      total = block_sum(total, red);
      for (int j = tid; j < S; j += nt) {
        const float v = reverse ? total : total * erow[j];
        s[j] = v;
        m = fmaxf(m, v);
      }
    } else {
      const float* M = b < num_static
          ? static_exp + (size_t)b * SS
          : be_exp + ((size_t)r * J + (size_t)(b - num_static)) * SS;
      if (!reverse) {
        product_forward(M, u, S, [&](int j, float x) {
          const float v = x * erow[j];
          s[j] = v;
          m = fmaxf(m, v);
        });
      } else {
        product_reverse(M, u, S, [&](int i, float x) {
          s[i] = x;
          m = fmaxf(m, x);
        });
      }
    }
    m = fmaxf(block_max(m, red), TINY);
    const float inv = 1.f / m;
    scale = scale + logf(m) + FM[t];
    for (int j = tid; j < S; j += nt) {
      const float v = s[j] * inv;
      u[j] = v;
      dst[j] = logf(fmaxf(v, TINY)) + scale;
    }
  }
}

// Grid (R*Q, 2) of `threads`, dynamic shared memory 2*S + 33 floats.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int R, int Q, int S, int threads, void* stream,
           Args... args) {
  const size_t smem = (2 * (size_t)S + 33) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(R * Q, 2);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fb_grouped_launch(const float* frames, const float* static_exp,
                                 const float* be_exp, const int* cbi,
                                 float* alphas, float* betas,
                                 int R, int Q, int L, int S, int Lm1,
                                 int num_static, int J, int threads,
                                 void* stream) {
  return launch(fb_grouped_kernel, R, Q, S, threads, stream, frames,
                static_exp, be_exp, cbi, alphas, betas, Q, L, S, Lm1,
                num_static, J);
}

extern "C" int fb_grouped_scaled_launch(const float* fexp, const float* fmax,
                                        const float* static_exp,
                                        const float* be_exp, const int* cbi,
                                        float* alphas, float* betas,
                                        int R, int Q, int L, int S, int Lm1,
                                        int num_static, int J, int threads,
                                        void* stream) {
  return launch(fb_grouped_scaled_kernel, R, Q, S, threads, stream, fexp,
                fmax, static_exp, be_exp, cbi, alphas, betas, Q, L, S, Lm1,
                num_static, J);
}

extern "C" const char* fb_grouped_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
