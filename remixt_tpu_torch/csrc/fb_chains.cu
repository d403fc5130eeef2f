// Chain-batched, log-space HMM forward-backward for one restart, one
// thread block cluster per (chain, direction).
//
// Replaces the TPU kernel _fb_kernel_wrapped (remixt_tpu/ops/fb_pallas.py:152)
// and computes what forward_backward_chains_pallas computes
// (fb_pallas.py:488) for one restart, with the semantics of fb_grouped.cu:
//   cut class (bank index 0):  s = sum(u), the same for every state;
//   any other step:            s = u . M (forward) or M . u (reverse), with M
//                              a static class matrix or breakend matrix j;
//   result = log(max(s, TINY)) + max, plus the frame in the forward direction.
// The reverse direction adds the frame before taking the max, and both
// directions run through the pad positions after a chain's end (cut steps
// with zero frames), so the betas carry the reference's per-chain shift.
// Nothing of the TPU layout is kept: no one-hot class plane, no flat
// junction schedule, no DMA ring, no padding of states or lanes.
//
// What bounds it on an H100. At whole-genome width (Q=23 chains of up to
// L~266 positions, S=355, J<=600) the breakend bank is J*S*S*4 B ~ 0.30 GB
// and frames plus outputs ~26 MB: ~0.1 ms at 3.35 TB/s. The fp32 work is
// ~2 directions * (Q*L) matvecs * 2*S^2 ~ 3 GFLOP, ~0.05 ms at 67 TFLOP/s.
// Both are far below the latency of the serial chain: every one of a
// chain's ~265 steps reads one 504 KB (S x S) matrix before the next step
// can start. One block per (chain, direction), as fb_grouped.cu runs at
// R=1, gives only 46 blocks for 132 SMs, each step limited by what one SM
// can read from L2 or device memory.
//
// Design: a cluster of C blocks (C <= 8, the portable cluster size) per
// (chain, direction). Block `rank` owns states [rank*per, rank*per + per)
// and keeps their log-space carry in its shared memory. Per step:
//   1. one warp of each block shifts its slice by the slice's own maximum,
//      and publishes u_c = exp(carry - m_c), m_c and sum(u_c) in its
//      shared memory;
//   2. one cluster barrier;
//   3. every block reads the C maxima through distributed shared memory,
//      takes m = max m_c, and gathers the whole u = u_c * exp(m_c - m) from
//      its peers; the cut class is sum_c sum(u_c) * exp(m_c - m);
//   4. each block computes its slice of the product: forward, columns
//      j of M[:, slice] (threads over j, row groups over i); reverse, rows
//      i of M[slice, :] (a warp per row); both read rows contiguously.
// The published u, maxima and sums are double-buffered, so the one cluster
// barrier per step also orders the next step's writes after the reads.
// Each block reads S*S/C matrix entries per step, C-fold fewer than one
// block per (chain, direction), over 46*C blocks. The wrapper gives each
// cluster about 2048 threads, so that all 46 clusters are resident at
// once at 64 registers a thread: on the whole-genome problem C=4 with 480
// threads a block and C=8 with 256 take 3.1-3.3 ms, against 10.5-10.9 ms
// for fb_grouped.cu at R=1 (chip_smoke.py phase 2b, H100 80GB HBM3,
// 700 W). At ~12 us a step it is
// still latency-bound, ~30x off the bytes bound: each thread issues ~70
// scalar loads a step, a few in flight at a time.
//
// The scaled-linear variant, fb_chains_scaled_kernel, replaces the TPU
// kernel _fb_kernel_scaled (fb_pallas.py:260), the chain update of the
// single-restart fit under REMIXT_TPU_SCALED_LINEAR=1. It reads fexp =
// exp(frame - fmax) (Q, L, S) and fmax (Q, L) and keeps a linear carry
// normalised by its maximum, with a log scale beside it (see
// fb_grouped.cu). Its normaliser m is the maximum of the step's new
// product over all S states, known only after the exchange, so the block
// publishes the product rather than the carry; still one cluster barrier
// a step:
//   1. each block computes its slice s_c of the product (the forward one
//      already times its columns' fexp[t]) and publishes it with its
//      maximum m_c and its sum (reverse: weighted by the output position's
//      fexp, which the next step folds in);
//   2. one cluster barrier;
//   3. every block takes m = max(max_c m_c, TINY), scale += log(m) +
//      fmax[t], gathers the next product's input s / m (reverse: times
//      fexp of the output position) through distributed shared memory,
//      and writes its own slice's log(max(s_c / m, TINY)) + scale; the cut
//      class of the next step is sum_c sum_c / m.
// Every block of a cluster sees the same m and fmax, so each keeps the
// same scale without a further exchange. Its bound at whole-genome width
// is the log-space one: 0.330 GB moved once, 0.098 ms at 3.35 TB/s, above
// the fp32 3.05 GFLOP (0.046 ms). At C=4 it took 2.97 ms, the frame shift
// in torch (0.06 ms) included, against 3.10 ms for fb_chains_kernel in the
// same run (chip_smoke.py phase 2d, NVIDIA H100 80GB HBM3, 700 W): as
// latency-bound as the log-space kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float TINY = 1e-37f;
constexpr int MAX_CLUSTER = 8;

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

// The block's slice of the forward product u . M: its own columns
// [lo, lo + n_own), JW-wide, times G row groups; the row groups' partial
// sums meet in red (blockDim floats) behind one block barrier, which every
// thread must reach. epi(j, s) for each own column j.
template <typename Epi>
__device__ __forceinline__ void slice_forward(const float* M, const float* u,
                                              int S, int lo, int n_own,
                                              int JW, int G, float* red,
                                              Epi epi) {
  const int tid = threadIdx.x;
  const int jj = tid % JW, g = tid / JW;
  float acc = 0.f;
  if (g < G && jj < n_own) {
    const float* col = M + lo + jj;
#pragma unroll 4
    for (int i = g; i < S; i += G) acc = fmaf(u[i], col[(size_t)i * S], acc);
  }
  red[tid] = acc;
  __syncthreads();
  for (int j = tid; j < n_own; j += blockDim.x) {
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += red[gg * JW + j];
    epi(j, s);
  }
}

// The block's slice of the reverse product M . u: its own rows, a warp
// per row; lane 0 calls epi(i, s) for own row i.
template <typename Epi>
__device__ __forceinline__ void slice_reverse(const float* M, const float* u,
                                              int S, int lo, int n_own,
                                              Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n_own; i += nwarps) {
    const float* row = M + (size_t)(lo + i) * S;
    float s = 0.f;
#pragma unroll 4
    for (int j = lane; j < S; j += 32) s = fmaf(row[j], u[j], s);
    s = warp_sum(s);
    if (lane == 0) epi(i, s);
  }
}

// frames (Q, L, S); static_exp (num_static, S, S); be_exp (J, S, S);
// cbi (Q, Lm1) int32, value < num_static a static class, num_static + j
// breakend j; alphas, betas (Q, L, S). Grid (C, Q, 2) in clusters of
// (C, 1, 1); blockDim a multiple of 32; per = ceil(S / C).
__global__ void __launch_bounds__(1024)
fb_chains_kernel(const float* __restrict__ frames,
                 const float* __restrict__ static_exp,
                 const float* __restrict__ be_exp,
                 const int* __restrict__ cbi,
                 float* __restrict__ alphas, float* __restrict__ betas,
                 int L, int S, int Lm1, int num_static, int per) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int lo = rank * per;
  const int n_own = max(0, min(per, S - lo));

  float* carry = smem;               // per: log-space carry of the slice
  float* pub = carry + per;          // 2 x per: published shifted slice
  float* stat = pub + 2 * per;       // 2 x 2: published (max, sum)
  float* u = stat + 4;               // S: the gathered shifted vector
  float* red = u + S;                // blockDim.x: forward partial sums

  const size_t SS = (size_t)S * S;
  const float* F = frames + (size_t)q * L * S;
  float* out = (reverse ? betas : alphas) + (size_t)q * L * S;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // forward product: JW columns per row group, G row groups
  const int JW = ((per + 31) / 32) * 32;
  const int G = max(1, nt / JW);

  for (int i = tid; i < n_own; i += nt) {
    const float v = reverse ? 0.f : F[lo + i];
    carry[i] = v;
    out[(size_t)(reverse ? L - 1 : 0) * S + lo + i] = v;
  }

  for (int step = 1; step < L; ++step) {
    // forward: pair (t-1, t) produces position t from frame t;
    // reverse: pair (t-1, t) produces position t-1 from frame t
    const int t = reverse ? L - step : step;
    const float* frow = F + (size_t)t * S;
    float* dst = out + (size_t)(reverse ? t - 1 : t) * S;
    float* my_pub = pub + (step & 1) * per;
    float* my_stat = stat + (step & 1) * 2;
    __syncthreads();  // the previous step's carry is written

    if (warp == 0) {
      float m = -INFINITY;
      for (int i = lane; i < n_own; i += 32) {
        float c = carry[i];
        if (reverse) {
          c += frow[lo + i];
          carry[i] = c;
        }
        m = fmaxf(m, c);
      }
      m = warp_max(m);
      float s = 0.f;
      for (int i = lane; i < n_own; i += 32) {
        const float e = expf(carry[i] - m);
        my_pub[i] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) {
        my_stat[0] = m;
        my_stat[1] = s;
      }
    }
    cluster.sync();

    float scale[MAX_CLUSTER];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < C) {
        scale[c] = cluster.map_shared_rank(my_stat, c)[0];
        m = fmaxf(m, scale[c]);
      }
    }
    float total = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < C) {
        scale[c] = expf(scale[c] - m);
        total = fmaf(cluster.map_shared_rank(my_stat, c)[1], scale[c], total);
      }
    }
    for (int i = tid; i < S; i += nt) {
      const int c = i / per;
      u[i] = cluster.map_shared_rank(my_pub, c)[i - c * per] * scale[c];
    }
    __syncthreads();

    const int b = bidx[t - 1];
    if (b == 0) {
      const float val = logf(fmaxf(total, TINY)) + m;
      for (int i = tid; i < n_own; i += nt) {
        const float v = reverse ? val : val + frow[lo + i];
        carry[i] = v;
        dst[lo + i] = v;
      }
      continue;
    }
    const float* M = b < num_static
        ? static_exp + (size_t)b * SS
        : be_exp + (size_t)(b - num_static) * SS;
    if (!reverse) {
      slice_forward(M, u, S, lo, n_own, JW, G, red, [&](int j, float s) {
        const float v = logf(fmaxf(s, TINY)) + m + frow[lo + j];
        carry[j] = v;
        dst[lo + j] = v;
      });
    } else {
      slice_reverse(M, u, S, lo, n_own, [&](int i, float s) {
        const float v = logf(fmaxf(s, TINY)) + m;
        carry[i] = v;
        dst[lo + i] = v;
      });
    }
  }
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

// The scaled-linear kernel: fexp (Q, L, S) = exp(frame - fmax), fmax
// (Q, L); grid, clusters and the rest as fb_chains_kernel.
__global__ void __launch_bounds__(1024)
fb_chains_scaled_kernel(const float* __restrict__ fexp,
                        const float* __restrict__ fmax,
                        const float* __restrict__ static_exp,
                        const float* __restrict__ be_exp,
                        const int* __restrict__ cbi,
                        float* __restrict__ alphas, float* __restrict__ betas,
                        int L, int S, int Lm1, int num_static, int per) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int lo = rank * per;
  const int n_own = max(0, min(per, S - lo));

  float* pub = smem;                 // 2 x per: published product slice
  float* stat = pub + 2 * per;       // 2 x 2: published (max, sum)
  float* first = stat + 4;           // 1: sum of the first input vector
  float* u = first + 1;              // S: the next product's input vector
  float* red = u + S;                // blockDim.x: forward partial sums

  const size_t SS = (size_t)S * S;
  const float* E = fexp + (size_t)q * L * S;
  const float* FM = fmax + (size_t)q * L;
  float* out = (reverse ? betas : alphas) + (size_t)q * L * S;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int JW = ((per + 31) / 32) * 32;
  const int G = max(1, nt / JW);

  // the first input: forward u = fexp[0] at scale fmax[0]; reverse u = 1
  // at scale 0 (message 0), times fexp[L-1] folded in
  const int t0 = reverse ? L - 1 : 0;
  const float* e0 = E + (size_t)t0 * S;
  float scale = reverse ? 0.f : FM[0];
  for (int i = tid; i < S; i += nt) u[i] = e0[i];
  for (int i = tid; i < n_own; i += nt)
    out[(size_t)t0 * S + lo + i] =
        reverse ? 0.f : logf(fmaxf(e0[lo + i], TINY)) + scale;
  if (warp == 0) {
    float sum = 0.f;
    for (int i = lane; i < S; i += 32) sum += e0[i];
    sum = warp_sum(sum);
    if (lane == 0) first[0] = sum;
  }
  __syncthreads();
  float total = first[0];  // the cut class's sum of the input vector

  for (int step = 1; step < L; ++step) {
    const int t = reverse ? L - step : step;
    const float* erow = E + (size_t)t * S;
    // reverse: the output position's fexp, folded into the next input
    const float* eout = E + (size_t)(t - 1) * S;
    float* dst = out + (size_t)(reverse ? t - 1 : t) * S;
    float* my_pub = pub + (step & 1) * per;
    float* my_stat = stat + (step & 1) * 2;
    __syncthreads();  // the input vector is gathered

    const int b = bidx[t - 1];
    if (b == 0) {
      for (int j = tid; j < n_own; j += nt)
        my_pub[j] = reverse ? total : total * erow[lo + j];
    } else {
      const float* M = b < num_static
          ? static_exp + (size_t)b * SS
          : be_exp + (size_t)(b - num_static) * SS;
      if (!reverse) {
        slice_forward(M, u, S, lo, n_own, JW, G, red,
                      [&](int j, float s) { my_pub[j] = s * erow[lo + j]; });
      } else {
        slice_reverse(M, u, S, lo, n_own,
                      [&](int i, float s) { my_pub[i] = s; });
      }
    }
    __syncthreads();  // the slice is complete
    if (warp == 0) {
      float m = 0.f, sum = 0.f;
      for (int i = lane; i < n_own; i += 32) {
        const float x = my_pub[i];
        m = fmaxf(m, x);
        sum = reverse ? fmaf(x, eout[lo + i], sum) : sum + x;
      }
      m = warp_max(m);
      sum = warp_sum(sum);
      if (lane == 0) {
        my_stat[0] = m;
        my_stat[1] = sum;
      }
    }
    cluster.sync();

    float m = TINY, sum = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < C) {
        const float* peer = cluster.map_shared_rank(my_stat, c);
        m = fmaxf(m, peer[0]);
        sum += peer[1];
      }
    }
    const float inv = 1.f / m;
    total = sum * inv;
    scale = scale + logf(m) + FM[t];
    for (int i = tid; i < S; i += nt) {
      const int c = i / per;
      const float x = cluster.map_shared_rank(my_pub, c)[i - c * per] * inv;
      u[i] = reverse ? x * eout[i] : x;
    }
    for (int j = tid; j < n_own; j += nt)
      dst[lo + j] = logf(fmaxf(my_pub[j] * inv, TINY)) + scale;
  }
  // no block may leave while a peer can still read its shared memory
  cluster.sync();
}

// Grid (C, Q, 2) in clusters of C blocks of `threads`, `smem` bytes of
// dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int Q, int cluster, int threads,
           void* stream, Args... args) {
  if (cluster < 1 || cluster > MAX_CLUSTER || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Q, 2);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fb_chains_launch(const float* frames, const float* static_exp,
                                const float* be_exp, const int* cbi,
                                float* alphas, float* betas,
                                int Q, int L, int S, int Lm1, int num_static,
                                int cluster, int threads, void* stream) {
  const int per = cluster > 0 ? (S + cluster - 1) / cluster : 0;
  const size_t smem = ((size_t)3 * per + 4 + S + threads) * sizeof(float);
  return launch(fb_chains_kernel, smem, Q, cluster, threads, stream, frames,
                static_exp, be_exp, cbi, alphas, betas, L, S, Lm1,
                num_static, per);
}

extern "C" int fb_chains_scaled_launch(const float* fexp, const float* fmax,
                                       const float* static_exp,
                                       const float* be_exp, const int* cbi,
                                       float* alphas, float* betas,
                                       int Q, int L, int S, int Lm1,
                                       int num_static, int cluster,
                                       int threads, void* stream) {
  const int per = cluster > 0 ? (S + cluster - 1) / cluster : 0;
  const size_t smem = ((size_t)2 * per + 5 + S + threads) * sizeof(float);
  return launch(fb_chains_scaled_kernel, smem, Q, cluster, threads, stream,
                fexp, fmax, static_exp, be_exp, cbi, alphas, betas, L, S, Lm1,
                num_static, per);
}

extern "C" const char* fb_chains_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
