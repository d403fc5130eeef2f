// Chain-batched, log-space HMM forward-backward for a wave of restarts.
//
// Replaces the TPU kernel _fb_kernel_grouped (remixt_tpu/ops/fb_pallas.py:744)
// and computes what forward_backward_chains_pallas_grouped computes
// (fb_pallas.py:1159), laid out for a GPU rather than copied block by block:
// no one-hot class plane, no flat junction schedule, no DMA ring, no
// junction-major bank transpose, no padding of lanes. Each step is
//   cut class (bank index 0):  s = sum(u), the same for every state;
//   any other step:            s = u . M (forward) or M . u (reverse), with M
//                              the chain's static class matrix or the
//                              restart's breakend matrix be_exp[r, j];
//   result = log(max(s, TINY)) + max, plus the frame in the forward direction,
// with u = exp(carry - max). The reverse direction adds the frame before
// taking the max (the TPU kernel's order), and both directions run through
// the pad positions after a chain's end (cut steps with zero frames), so
// the betas carry the same per-chain constant shift as the reference.
//
// Design. All R restarts of a chain walk the same class schedule, so one
// read of a static class matrix can serve all of them. A thread block
// cluster of C blocks runs each (chain, direction, tile of RT = 8
// restarts); block `rank` owns states [rank*per, rank*per + per) of every
// restart of the tile (per a multiple of 4) and keeps their log-space
// carry in shared memory. Per step:
//   1. a warp per restart shifts its slice by the slice maximum (reverse:
//      after adding the frame); the block writes the shifted slices into
//      every peer's vector tile ut (state i of restart r at i * RT + r,
//      double-buffered) and each slice's (max, sum) into every peer's
//      statistics, through distributed shared memory;
//   2. one cluster barrier;
//   3. each block takes every restart's common maximum over the C slices
//      and rescales the peers' parts of its ut in place; the cut class is
//      sum_c sum_c * exp(m_c - m);
//   4. the product of the block's slice for all restarts of the tile:
//      a static class (forward, and reverse as u . M^T): a thread loads 4
//        columns of a row at once and applies them to all RT vectors in
//        registers, so a static entry is read once per step for the tile
//        (not once per restart) and a row of ut once per 4 columns; the
//        wrapper stages the matrices and their transposes with rows padded
//        to a multiple of 4 floats (2 MB at S=355);
//      a breakend step (restart r's own matrix): forward, columns over
//        threads and row groups, reverse, a warp per row, RT loads a row;
//   5. log(max(s, TINY)) + max, plus the frame in the forward direction,
//      into the carry and the output.
// The frame slices are copied into shared memory (cp.async) and the class
// read a step ahead, so no load of them waits in a step. The double
// buffers make one cluster barrier a step enough: a block writes a peer's
// buffer of step s + 2 only after every block has passed step s + 1's
// barrier, which the peer reaches when it is done with step s.
//
// What bounds it on an H100. At whole-genome width (R=8, Q=23 chains of up
// to L~266 positions, S=355, J<=600) the breakend bank is R*J*S*S*4 B
// ~ 2.4 GB. The function's bound reads it once, with the frames, static
// bank, schedule and outputs: 2.63 GB, 0.785 ms at 3.35 TB/s, above the
// fp32 24.4 GFLOP (0.364 ms at 67 TFLOP/s). This design reads the bank once
// per direction (a floor of 5.05 GB, 1.51 ms) and the static classes once
// per step and tile (~5.5 GB from L2, 8x fewer than one block per restart
// read). At C=4 (480 threads a block, two blocks an SM) it took 5.19 ms,
// at C=8 6.87 ms, against 10.26-10.67 ms for one block per (restart,
// chain, direction); 3.61 ms with every breakend step made static
// (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700 W). Like fb_chains.cu
// it is bound by the chain's serial steps, not by bytes or operations:
// with every step static a step takes ~13.6 us (3.61 ms over 265 steps);
// the breakend steps, under a tenth of all, cost the other ~1.6 ms, each
// streaming 1 MB a block from device memory with RT * BANK_UNROLL = 16
// loads in flight a thread.
//
// The scaled-linear variant, fb_grouped_scaled_kernel, replaces the TPU
// kernel _fb_kernel_grouped_scaled (fb_pallas.py:911), the chain update of
// the batched fit under REMIXT_TPU_SCALED_LINEAR=1. One thread block per
// (restart, chain, direction), grid (R*Q, 2), which walks the chain in a
// loop; it reads fexp = exp(frame - fmax) (R, Q, L, S) and fmax (R, Q, L),
// made by the wrapper, and keeps the linear carry u in shared memory with
// one float of log scale per block. Each step is
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
// for a log-space kernel of the same grid in the same run (chip_smoke.py
// phase 2c, NVIDIA H100 80GB HBM3, 700 W): the same reads, without the
// expf per state.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float TINY = 1e-37f;
constexpr int MAX_CLUSTER = 8;
// restarts per tile of fb_grouped_kernel; warp_sum_tile and load_tile_row
// are written for 8
constexpr int RT = 8;
// rows of the breakend products unrolled: RT loads each in flight per
// thread
constexpr int BANK_UNROLL = 2;
// rows of the static product unrolled: one 16-byte load each
constexpr int STATIC_UNROLL = 2;

// Shared memory of fb_grouped_kernel, in floats: ut, carry, fbuf, stat,
// gmax, gsum and sched, before red (see the kernel). ops/fb_grouped.py
// counts the same in its tile_base_floats, and tests/test_torch_fb_grouped.py
// holds the two, RT and the launcher's per and SG to the Python plan.
size_t tile_base_floats(int S, int per) {
  return (size_t)2 * S * RT + (size_t)3 * RT * per + 4 * MAX_CLUSTER * RT
      + 2 * RT + 2;
}

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

// The RT vectors of a tile that one matrix entry meets: row i of the
// transposed tile ut[i * RT + r], 32 bytes read as two float4 (a warp
// broadcast where the warp reads one row).
__device__ __forceinline__ void load_tile_row(const float* row,
                                              float (&x)[RT]) {
  const float4 a = reinterpret_cast<const float4*>(row)[0];
  const float4 b = reinterpret_cast<const float4*>(row)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The warp sums of a[r] for all RT = 8 restarts in 9 shuffles rather than
// 40: each exchange halves the values a lane carries. Lanes 4r..4r+3
// return the sum of a[r].
__device__ __forceinline__ float warp_sum_tile(const float (&a)[RT],
                                               int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float b[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = (h16 ? a[k + 4] : a[k])
        + __shfl_xor_sync(0xffffffffu, h16 ? a[k] : a[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (h8 ? b[k + 2] : b[k])
        + __shfl_xor_sync(0xffffffffu, h8 ? b[k] : b[k + 2], 8);
  float d = (h4 ? c[1] : c[0])
      + __shfl_xor_sync(0xffffffffu, h4 ? c[0] : c[1], 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  return d;
}

// A 4-byte copy from global to shared memory that holds no register while
// in flight; copy_async_wait waits for the calling thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The forward products' epilogue: epi(r, j, s) for each restart r < nr and
// own column j, s the sum over G row groups of red[r * r_stride + g *
// g_stride + j].
template <typename Epi>
__device__ __forceinline__ void sum_partials(const float* red, int r_stride,
                                             int g_stride, int G, int nr,
                                             int n_own, Epi epi) {
  for (int k = threadIdx.x; k < nr * n_own; k += blockDim.x) {
    const int r = k / n_own, j = k % n_own;
    const float* part = red + r * r_stride + j;
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[g * g_stride];
    epi(r, j, s);
  }
}

// The block's slice of the static products u_r . M for all restarts r < nr
// of the tile: its own columns [lo, lo + n_own), a quad of 4 columns a
// thread (lo and per multiples of 4), times G row groups (thread tid: quad
// tid % (per / 4), rows i = tid / (per / 4) + k * G). M's rows are Sp
// floats apart, Sp a multiple of 4, so a quad is one 16-byte load, applied
// to the RT vectors in registers: one read of each entry serves the whole
// tile, and one read of a u row serves 4 columns. The row groups' partial
// sums meet in red (G x RT x per floats) behind block barriers, which
// every thread must reach. epi(r, j, s) for each restart r < nr and own
// column j.
template <typename Epi>
__device__ __forceinline__ void tile_static(const float* M, int Sp,
                                            const float* ut, int S, int lo,
                                            int n_own, int per, int G, int nr,
                                            float* red, Epi epi) {
  const int tid = threadIdx.x;
  const int quad = tid % (per / 4), g = tid / (per / 4);
  float acc[4][RT];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[c][r] = 0.f;
  if (g < G && quad * 4 < n_own) {
    const float* col = M + lo + quad * 4;
#pragma unroll(STATIC_UNROLL)
    for (int i = g; i < S; i += G) {
      const float4 m = *reinterpret_cast<const float4*>(col + (size_t)i * Sp);
      float x[RT];
      load_tile_row(ut + (size_t)i * RT, x);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[0][r] = fmaf(x[r], m.x, acc[0][r]);
        acc[1][r] = fmaf(x[r], m.y, acc[1][r]);
        acc[2][r] = fmaf(x[r], m.z, acc[2][r]);
        acc[3][r] = fmaf(x[r], m.w, acc[3][r]);
      }
    }
  }
  if (g < G) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(g * RT + r) * per + quad * 4 + c] = acc[c][r];
  }
  __syncthreads();
  sum_partials(red, per, RT * per, G, nr, n_own, epi);
}

// The block's slice of the breakend products of the tile, restart r's
// matrix at M + r * rstride, RT loads in flight per row and unrolled row.
// Forward, u_r . M_r: its own columns [lo, lo + n_own), JW-wide, times G
// row groups (thread tid: column tid % JW, rows i = tid / JW + k * G); the
// row groups' partial sums meet in red (RT x blockDim floats) behind block
// barriers, which every thread must reach.
template <typename Epi>
__device__ __forceinline__ void bank_forward(const float* M, size_t rstride,
                                             const float* ut, int S, int lo,
                                             int n_own, int JW, int G,
                                             int nr, float* red, Epi epi) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int jj = tid % JW, g = tid / JW;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  if (g < G && jj < n_own) {
    const float* col = M + lo + jj;
#pragma unroll(BANK_UNROLL)
    for (int i = g; i < S; i += G) {
      float x[RT];
      load_tile_row(ut + (size_t)i * RT, x);
      const float* e = col + (size_t)i * S;
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) acc[r] = fmaf(x[r], e[r * rstride], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) red[r * nt + tid] = acc[r];
  __syncthreads();
  sum_partials(red, nt, JW, G, nr, n_own, epi);
}

// Reverse, M_r . u_r: its own rows, a warp per row, the RT sums reduced
// together.
template <typename Epi>
__device__ __forceinline__ void bank_reverse(const float* M, size_t rstride,
                                             const float* ut, int S, int lo,
                                             int n_own, int nr, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n_own; i += nwarps) {
    const float* row = M + (size_t)(lo + i) * S;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
#pragma unroll(BANK_UNROLL)
    for (int j = lane; j < S; j += 32) {
      float x[RT];
      load_tile_row(ut + (size_t)j * RT, x);
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) acc[r] = fmaf(row[r * rstride + j], x[r], acc[r]);
    }
    const float s = warp_sum_tile(acc, lane);
    const int r = lane >> 2;
    if ((lane & 3) == 0 && r < nr) epi(r, i, s);
  }
}

// frames (R, Q, L, S); statics (2, num_static, S, Sp): the static class
// matrices and their transposes, rows padded to Sp = a multiple of 4 floats;
// be_exp (R, J, S, S); cbi (Q, Lm1) int32, value < num_static a static
// class, num_static + j breakend j; alphas, betas (R, Q, L, S). Grid (C, Q,
// 2 * ceil(R / RT)) in clusters of (C, 1, 1), blockIdx.z = 2 * tile +
// direction; blockDim a multiple of 32 and at least per rounded up to
// whole warps; per, a multiple of 4, times C at least S; dynamic shared
// memory tile_base_floats(S, per) floats and red: at least RT x blockDim
// and SG x RT x per floats, SG >= 1 the static product's row groups.
__global__ void __launch_bounds__(1024)
fb_grouped_kernel(const float* __restrict__ frames,
                  const float* __restrict__ statics,
                  const float* __restrict__ be_exp,
                  const int* __restrict__ cbi,
                  float* __restrict__ alphas, float* __restrict__ betas,
                  int R, int Q, int L, int S, int Sp, int Lm1,
                  int num_static, int J, int per, int SG) {
  extern __shared__ float4 smem_tile[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.y;
  const bool reverse = blockIdx.z & 1;
  const int r0 = (blockIdx.z >> 1) * RT;
  const int nr = min(RT, R - r0);  // the tile's restarts; the rest masked
  const int lo = rank * per;
  const int n_own = max(0, min(per, S - lo));

  // 2 x S x RT: each restart's shifted vector, transposed (state i of
  // restart r at i * RT + r), double-buffered; the peers write it
  float* ut = reinterpret_cast<float*>(smem_tile);
  float* carry = ut + (size_t)2 * S * RT;  // RT x per: the slice's carry
  float* fbuf = carry + RT * per;  // 2 x RT x per: the staged frame slices
  // 2 x MAX_CLUSTER x RT x 2: every peer's (max, sum) of its slice
  float* stat = fbuf + 2 * RT * per;
  float* gmax = stat + 4 * MAX_CLUSTER * RT;  // RT: each restart's maximum
  float* gsum = gmax + RT;                    // RT: its cut-class sum
  // 2: the staged class of a step, double-buffered
  int* sched = reinterpret_cast<int*>(gsum + RT);
  // the products' partial sums; before them in a step, the shifted slices
  // (RT x per) on their way to the peers
  float* red = gsum + RT + 2;

  const size_t SS = (size_t)S * S, LS = (size_t)L * S;
  const size_t lane_stride = (size_t)Q * LS;  // restart r to r + 1
  const size_t bank_stride = (size_t)J * SS;
  const float* F = frames + ((size_t)r0 * Q + q) * LS;
  float* out = (reverse ? betas : alphas) + ((size_t)r0 * Q + q) * LS;
  const float* bank = be_exp + (size_t)r0 * bank_stride;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  // breakend forward product: JW columns per row group, G row groups
  const int JW = ((per + 31) / 32) * 32;
  const int G = max(1, nt / JW);
  const size_t SSp = (size_t)S * Sp;

  // frame row t's slice of each restart, copied into fb (RT x per)
  auto stage_frames = [&](int t, float* fb) {
    for (int k = tid; k < nr * n_own; k += nt) {
      const int r = k / n_own, i = k % n_own;
      copy_async(fb + r * per + i,
                 F + r * lane_stride + (size_t)t * S + lo + i);
    }
  };

  // the frames and class of the step at t, copied a step ahead into
  // shared memory buffer buf, so that no step waits for their loads
  auto stage = [&](int t, int buf) {
    stage_frames(t, fbuf + buf * RT * per);
    if (tid == 0)
      copy_async(reinterpret_cast<float*>(sched + buf),
                 reinterpret_cast<const float*>(bidx + t - 1));
  };
  if (L > 1) stage(reverse ? L - 1 : 1, 1);
  for (int k = tid; k < nr * n_own; k += nt) {
    const int r = k / n_own, i = k % n_own;
    const size_t at = r * lane_stride + (size_t)(reverse ? L - 1 : 0) * S
        + lo + i;
    const float v = reverse ? 0.f : F[at];
    carry[r * per + i] = v;
    out[at] = v;
  }
  // the masked restarts' vectors stay zero: no peer writes them
  for (int k = tid; k < 2 * S * RT; k += nt)
    if (k % RT >= nr) ut[k] = 0.f;
  // every block of the cluster runs before a peer writes its shared memory
  cluster.sync();

  for (int step = 1; step < L; ++step) {
    // forward: pair (t-1, t) produces position t from frame t;
    // reverse: pair (t-1, t) produces position t-1 from frame t
    const int t = reverse ? L - step : step;
    const int buf = step & 1;
    float* my_ut = ut + (size_t)buf * S * RT;
    float* my_stat = stat + buf * MAX_CLUSTER * RT * 2;
    const float* fr = fbuf + buf * RT * per;  // frame t's slices
    copy_async_wait();
    __syncthreads();  // the previous step's carry is written, t staged

    const int b = sched[buf];
    if (step + 1 < L) stage(reverse ? t - 1 : t + 1, buf ^ 1);

    // a warp per restart shifts its slice by the slice maximum (reverse:
    // after adding the frame), stages it in red and sends every peer the
    // maximum and the sum
    for (int r = warp; r < nr; r += nwarps) {
      float* c = carry + r * per;
      const float* f = fr + r * per;
      float m = -INFINITY;
      for (int i = lane; i < n_own; i += 32) {
        float x = c[i];
        if (reverse) {
          x += f[i];
          c[i] = x;
        }
        m = fmaxf(m, x);
      }
      m = warp_max(m);
      float s = 0.f;
      for (int i = lane; i < n_own; i += 32) {
        const float e = expf(c[i] - m);
        red[r * per + i] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane < C) {
        float* peer = cluster.map_shared_rank(my_stat, lane);
        *reinterpret_cast<float2*>(peer + (rank * RT + r) * 2) =
            make_float2(m, s);
      }
    }
    __syncthreads();
    // every peer gets the slice, transposed into its u
    for (int k = tid; k < n_own * RT; k += nt) {
      const int i = k / RT, r = k % RT;
      if (r < nr) {
        const float v = red[r * per + i];
        const size_t at = (size_t)(lo + i) * RT + r;
        for (int c = 0; c < C; ++c) cluster.map_shared_rank(my_ut, c)[at] = v;
      }
    }
    cluster.sync();

    // each restart's common maximum over the peers' slices: thread tid
    // serves restart tid % RT (blockDim is a multiple of RT) and rescales
    // the peers' slices of its u
    {
      const int r = tid % RT;
      if (r < nr) {
        const float2* peer = reinterpret_cast<const float2*>(my_stat) + r;
        float m = -INFINITY, total = 0.f;
        for (int c = 0; c < C; ++c) m = fmaxf(m, peer[c * RT].x);
        for (int c = 0; c < C; ++c) {
          const float2 ms = peer[c * RT];
          const float scale = expf(ms.x - m);
          total = fmaf(ms.y, scale, total);
          const int n = min(per, S - c * per);
          for (int i = tid / RT; i < n; i += nt / RT)
            my_ut[(size_t)(c * per + i) * RT + r] *= scale;
        }
        if (tid < RT) {
          gmax[r] = m;
          gsum[r] = total;
        }
      }
    }
    __syncthreads();

    const size_t drow = (size_t)(reverse ? t - 1 : t) * S + lo;
    auto store = [&](int r, int i, float v) {
      carry[r * per + i] = v;
      out[r * lane_stride + drow + i] = v;
    };
    auto epi = [&](int r, int i, float s) {
      const float v = logf(fmaxf(s, TINY)) + gmax[r];
      store(r, i, reverse ? v : v + fr[r * per + i]);
    };
    if (b == 0) {
      for (int k = tid; k < nr * n_own; k += nt) {
        const int r = k / n_own, i = k % n_own;
        const float v = logf(fmaxf(gsum[r], TINY)) + gmax[r];
        store(r, i, reverse ? v : v + fr[r * per + i]);
      }
    } else if (b < num_static) {
      // reverse: M . u is u . M^T, columns of the transposed matrix
      const float* M = statics + ((size_t)reverse * num_static + b) * SSp;
      tile_static(M, Sp, my_ut, S, lo, n_own, per, SG, nr, red, epi);
    } else {
      const float* M = bank + (size_t)(b - num_static) * SS;
      if (!reverse)
        bank_forward(M, bank_stride, my_ut, S, lo, n_own, JW, G, nr, red,
                     epi);
      else
        bank_reverse(M, bank_stride, my_ut, S, lo, n_own, nr, epi);
    }
  }
  // no block may leave while a peer can still write its shared memory
  cluster.sync();
}

// The scaled-linear kernel: fexp (R, Q, L, S) = exp(frame - fmax), fmax
// (R, Q, L); static_exp (num_static, S, S), be_exp, cbi and the outputs as
// fb_grouped_kernel's. Grid (R*Q, 2): a block per (restart, chain,
// direction).
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

// fb_grouped_scaled_kernel's grid: (R*Q, 2) of `threads`, dynamic shared
// memory 2*S + 33 floats.
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

// Grid (cluster, Q, 2 * ceil(R / RT)) in clusters of `cluster` blocks of
// `threads`, `smem` bytes of dynamic shared memory: tile_base_floats and
// red, which takes the breakend products' partial sums (RT x threads) and
// the static product's of as many row groups as fit, at least one.
extern "C" int fb_grouped_launch(const float* frames, const float* statics,
                                 const float* be_exp, const int* cbi,
                                 float* alphas, float* betas,
                                 int R, int Q, int L, int S, int Lm1,
                                 int num_static, int J, int cluster,
                                 int threads, int smem, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int Sp = (S + 3) / 4 * 4;
  const int per = ((S + cluster - 1) / cluster + 3) / 4 * 4;
  const int JW = (per + 31) / 32 * 32;
  if (threads % 32 != 0 || threads > 1024 || threads < JW)
    return (int)cudaErrorInvalidValue;
  const size_t red = smem / sizeof(float) - tile_base_floats(S, per);
  if ((size_t)smem < tile_base_floats(S, per) * sizeof(float)
      || red < (size_t)RT * threads || red < (size_t)RT * per)
    return (int)cudaErrorInvalidValue;
  const int SG = (int)min(
      (size_t)min(threads / (per / 4), S), red / ((size_t)RT * per));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fb_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Q, 2 * ((R + RT - 1) / RT));
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
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fb_grouped_kernel, frames, statics, be_exp, cbi, alphas, betas,
      R, Q, L, S, Sp, Lm1, num_static, J, per, SG);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
