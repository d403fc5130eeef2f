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
// the batched fit under REMIXT_TPU_SCALED_LINEAR=1. It reads fexp =
// exp(frame - fmax) (R, Q, L, S) and fmax (R, Q, L), made by the wrapper,
// and keeps a linear input u per restart, normalised by its maximum, with
// a log scale beside it. Each step is
//   s = (u . M) * fexp[t] forward, s = M . (u * fexp[t]) reverse (the cut
//   class sums), m = max(max(s), TINY), u = s / m, scale += log(m) + fmax[t],
// and writes log(max(u, TINY)) + scale: the per-state expf of the carry
// becomes a multiply; the output's logf stays. Only the output is floored,
// so states far below a lane's maximum differ from the log-space kernel,
// which it matches within 60 nats of the row maximum.
// Same grid, clusters, tiles, slices and products as fb_grouped_kernel;
// only the exchange around the product differs. The normaliser m is the
// maximum of the step's new product over all S states, known only after
// the exchange, so a block publishes its slice of the product, not of its
// input (as fb_chains_scaled_kernel does); still one cluster barrier a step:
//   1. the product of the block's slice for all restarts of the tile
//      (forward times its columns' fexp[t]; the cut class from the input's
//      sum);
//   2. the block writes the slice into every peer's next input tile ut
//      (reverse: weighted by fexp of the output position t - 1, which the
//      next product folds in) and each slice's (max, sum) into every
//      peer's statistics;
//   3. one cluster barrier;
//   4. per restart, m = max(max_c m_c, TINY), the same in every block, so
//      each keeps the same scale with no further exchange; the next input
//      is rescaled by 1 / m in place before its product (the plain
//      version's order: a product of raw s would fall into subnormals as m
//      nears TINY), its sum is sum_c sum_c / m, and the block writes
//      log(max(s_c / m, TINY)) + scale for its own states.
// fexp slices, fmax and the class come a step ahead through cp.async.
// No atomics, and every reduction has a fixed order, so two launches on
// the same inputs give the same bits. Its bound at whole-genome width is
// the log-space one: fexp and fmax replace the frames (0.2 MB more), 2.63
// GB moved once, 0.785 ms at 3.35 TB/s, above the fp32 24.4 GFLOP (0.364
// ms at 67 TFLOP/s). At C=4 it took 5.41-5.44 ms, the frame shift in torch
// (0.16 ms) included, within 1.2 % of fb_grouped_kernel in the same run,
// and 6.65-6.66 ms at C=8; 3.68-3.98 ms with every breakend step made
// static. One block per (restart, chain, direction), which read every
// static matrix once per restart, took 8.42-8.60 ms (chip_smoke.py phase
// 2c, NVIDIA H100 80GB HBM3, 700 W). It is bound as fb_grouped_kernel is,
// by the chain's serial steps and the breakend bank's reads.

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

// fb_grouped_scaled_kernel's: the same, with slice for carry and total,
// gscale, ginv and the staged fmax (5 x RT) for gmax and gsum (2 x RT);
// ops/fb_grouped.py's scaled_base_floats counts the same.
size_t scaled_base_floats(int S, int per) {
  return tile_base_floats(S, per) + 3 * RT;
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

// The slices [0, n_own) of a row of each of the tile's nr restarts, restart
// r's at src + r * rstride, copied into dst (RT x per) by cp.async.
__device__ __forceinline__ void stage_slices(float* dst, const float* src,
                                             size_t rstride, int n_own,
                                             int per, int nr) {
  for (int k = threadIdx.x; k < nr * n_own; k += blockDim.x) {
    const int r = k / n_own, i = k % n_own;
    copy_async(dst + r * per + i, src + r * rstride + i);
  }
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

  // the frames and class of the step at t, copied a step ahead into
  // shared memory buffer buf, so that no step waits for their loads
  auto stage = [&](int t, int buf) {
    stage_slices(fbuf + buf * RT * per, F + (size_t)t * S + lo, lane_stride,
                 n_own, per, nr);
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
// (R, Q, L); statics, be_exp, cbi, the outputs, grid, clusters and block
// as fb_grouped_kernel's; dynamic shared memory scaled_base_floats(S, per)
// floats and red as there.
__global__ void __launch_bounds__(1024)
fb_grouped_scaled_kernel(const float* __restrict__ fexp,
                         const float* __restrict__ fmax,
                         const float* __restrict__ statics,
                         const float* __restrict__ be_exp,
                         const int* __restrict__ cbi,
                         float* __restrict__ alphas,
                         float* __restrict__ betas,
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

  // 2 x S x RT: each restart's product input, transposed (state i of
  // restart r at i * RT + r), double-buffered; the peers write it
  float* ut = reinterpret_cast<float*>(smem_tile);
  float* slice = ut + (size_t)2 * S * RT;  // RT x per: the step's product
  // 2 x RT x per: the staged fexp slices, forward of row t, reverse of the
  // output row t - 1
  float* fbuf = slice + RT * per;
  // 2 x MAX_CLUSTER x RT x 2: every peer's (max, sum) of its slice
  float* stat = fbuf + 2 * RT * per;
  float* total = stat + 4 * MAX_CLUSTER * RT;  // RT: each input's sum
  float* gscale = total + RT;                  // RT: each restart's scale
  float* ginv = gscale + RT;                   // RT: 1 / its normaliser
  float* mbuf = ginv + RT;                     // 2 x RT: the staged fmax
  // 2: the staged class of a step, double-buffered
  int* sched = reinterpret_cast<int*>(mbuf + 2 * RT);
  float* red = mbuf + 2 * RT + 2;  // the products' partial sums

  const size_t SS = (size_t)S * S, LS = (size_t)L * S;
  const size_t lane_stride = (size_t)Q * LS;  // restart r to r + 1
  const size_t bank_stride = (size_t)J * SS;
  const size_t QL = (size_t)Q * L;
  const float* E = fexp + ((size_t)r0 * Q + q) * LS;
  const float* FM = fmax + ((size_t)r0 * Q + q) * L;
  float* out = (reverse ? betas : alphas) + ((size_t)r0 * Q + q) * LS;
  const float* bank = be_exp + (size_t)r0 * bank_stride;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int JW = ((per + 31) / 32) * 32;
  const int G = max(1, nt / JW);
  const size_t SSp = (size_t)S * Sp;

  // the fexp slices, fmax and class of the step at t, copied a step ahead
  // into shared memory buffer buf
  auto stage = [&](int t, int buf) {
    stage_slices(fbuf + buf * RT * per, E + (size_t)(reverse ? t - 1 : t) * S
                 + lo, lane_stride, n_own, per, nr);
    if (tid < nr) copy_async(mbuf + buf * RT + tid, FM + tid * QL + t);
    if (tid == 0)
      copy_async(reinterpret_cast<float*>(sched + buf),
                 reinterpret_cast<const float*>(bidx + t - 1));
  };
  if (L > 1) stage(reverse ? L - 1 : 1, 1);
  // the first input, step 1's: forward u = fexp[0] at scale fmax[0];
  // reverse u = 1 at scale 0 (message 0), times fexp[L - 1]. The masked
  // restarts' inputs stay zero: no peer writes them
  const int t0 = reverse ? L - 1 : 0;
  for (int k = tid; k < 2 * S * RT; k += nt)
    if (k % RT >= nr) ut[k] = 0.f;
  for (int k = tid; k < nr * S; k += nt) {
    const int r = k / S, i = k % S;
    ut[(size_t)(S + i) * RT + r] = E[r * lane_stride + (size_t)t0 * S + i];
  }
  for (int k = tid; k < nr * n_own; k += nt) {
    const int r = k / n_own, i = k % n_own;
    const size_t at = r * lane_stride + (size_t)t0 * S + lo + i;
    out[at] = reverse ? 0.f : logf(fmaxf(E[at], TINY)) + FM[r * QL];
  }
  for (int r = warp; r < nr; r += nwarps) {
    const float* e = E + r * lane_stride + (size_t)t0 * S;
    float s = 0.f;
    for (int i = lane; i < S; i += 32) s += e[i];
    s = warp_sum(s);
    if (lane == 0) total[r] = s;
  }
  if (tid < nr) gscale[tid] = reverse ? 0.f : FM[tid * QL];
  // every block of the cluster runs before a peer writes its shared memory
  cluster.sync();

  for (int step = 1; step < L; ++step) {
    // forward: pair (t-1, t) produces position t from frame t;
    // reverse: pair (t-1, t) produces position t-1 from frame t
    const int t = reverse ? L - step : step;
    const int buf = step & 1;
    const float* my_ut = ut + (size_t)buf * S * RT;
    float* next_ut = ut + (size_t)(buf ^ 1) * S * RT;
    float* my_stat = stat + buf * MAX_CLUSTER * RT * 2;
    const float* fr = fbuf + buf * RT * per;
    const float* fm = mbuf + buf * RT;  // fmax[t]
    copy_async_wait();
    __syncthreads();  // the input is normalised, the step at t staged

    const int b = sched[buf];
    if (step + 1 < L) stage(reverse ? t - 1 : t + 1, buf ^ 1);

    // 1. the block's slice of the product, forward times fexp[t]
    auto epi = [&](int r, int i, float s) {
      slice[r * per + i] = reverse ? s : s * fr[r * per + i];
    };
    if (b == 0) {
      for (int k = tid; k < nr * n_own; k += nt) {
        const int r = k / n_own, i = k % n_own;
        epi(r, i, total[r]);
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
    __syncthreads();  // the slice is complete

    // 2. a warp per restart sends every peer the slice's maximum and sum
    // (reverse: weighted by fexp[t - 1]); the block writes the slice, so
    // weighted, into every peer's next input
    for (int r = warp; r < nr; r += nwarps) {
      const float* s = slice + r * per;
      const float* f = fr + r * per;
      float m = 0.f, sum = 0.f;
      for (int i = lane; i < n_own; i += 32) {
        m = fmaxf(m, s[i]);
        sum += reverse ? s[i] * f[i] : s[i];
      }
      m = warp_max(m);
      sum = warp_sum(sum);
      if (lane < C) {
        float* peer = cluster.map_shared_rank(my_stat, lane);
        *reinterpret_cast<float2*>(peer + (rank * RT + r) * 2) =
            make_float2(m, sum);
      }
    }
    for (int k = tid; k < n_own * RT; k += nt) {
      const int i = k / RT, r = k % RT;
      if (r < nr) {
        const float v = reverse ? slice[r * per + i] * fr[r * per + i]
                                : slice[r * per + i];
        const size_t at = (size_t)(lo + i) * RT + r;
        for (int c = 0; c < C; ++c)
          cluster.map_shared_rank(next_ut, c)[at] = v;
      }
    }
    // 3.
    cluster.sync();

    // 4. each restart's normaliser over the peers' maxima: thread tid
    // serves restart tid % RT (blockDim is a multiple of RT), rescales its
    // next input in place, and thread r keeps restart r's scale and sum
    {
      const int r = tid % RT;
      if (r < nr) {
        const float2* peer = reinterpret_cast<const float2*>(my_stat) + r;
        float m = TINY, sum = 0.f;
        for (int c = 0; c < C; ++c) {
          const float2 ms = peer[c * RT];
          m = fmaxf(m, ms.x);
          sum += ms.y;
        }
        const float inv = 1.f / m;
        for (int i = tid / RT; i < S; i += nt / RT)
          next_ut[(size_t)i * RT + r] *= inv;
        if (tid < RT) {
          gscale[r] = gscale[r] + logf(m) + fm[r];
          ginv[r] = inv;
          total[r] = sum * inv;
        }
      }
    }
    __syncthreads();

    const size_t drow = (size_t)(reverse ? t - 1 : t) * S + lo;
    for (int k = tid; k < nr * n_own; k += nt) {
      const int r = k / n_own, i = k % n_own;
      out[r * lane_stride + drow + i] =
          logf(fmaxf(slice[r * per + i] * ginv[r], TINY)) + gscale[r];
    }
  }
  // no block may leave while a peer can still write its shared memory
  cluster.sync();
}

// Grid (cluster, Q, 2 * ceil(R / RT)) in clusters of `cluster` blocks of
// `threads`, `smem` bytes of dynamic shared memory: the kernel's base
// floats (scaled_base_floats for the scaled kernel, else tile_base_floats)
// and red, which takes the breakend products' partial sums (RT x threads)
// and the static product's of as many row groups as fit, at least one.
// args are the kernel's arguments before per and SG, which follow them.
template <typename Kernel, typename... Args>
int launch_tile(Kernel kernel, bool scaled, int R, int Q, int S,
                int cluster, int threads, int smem, void* stream,
                Args... args) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int per = ((S + cluster - 1) / cluster + 3) / 4 * 4;
  const int JW = (per + 31) / 32 * 32;
  if (threads % 32 != 0 || threads > 1024 || threads < JW)
    return (int)cudaErrorInvalidValue;
  const size_t base =
      scaled ? scaled_base_floats(S, per) : tile_base_floats(S, per);
  if (smem < 0 || (size_t)smem < base * sizeof(float))
    return (int)cudaErrorInvalidValue;
  const size_t red = smem / sizeof(float) - base;
  if (red < (size_t)RT * threads || red < (size_t)RT * per)
    return (int)cudaErrorInvalidValue;
  const int SG = (int)min(
      (size_t)min(threads / (per / 4), S), red / ((size_t)RT * per));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., per, SG);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fb_grouped_launch(const float* frames, const float* statics,
                                 const float* be_exp, const int* cbi,
                                 float* alphas, float* betas,
                                 int R, int Q, int L, int S, int Lm1,
                                 int num_static, int J, int cluster,
                                 int threads, int smem, void* stream) {
  return launch_tile(fb_grouped_kernel, false, R, Q, S, cluster, threads,
                     smem, stream, frames, statics, be_exp, cbi, alphas,
                     betas, R, Q, L, S, (S + 3) / 4 * 4, Lm1, num_static, J);
}

extern "C" int fb_grouped_scaled_launch(const float* fexp, const float* fmax,
                                        const float* statics,
                                        const float* be_exp, const int* cbi,
                                        float* alphas, float* betas,
                                        int R, int Q, int L, int S, int Lm1,
                                        int num_static, int J, int cluster,
                                        int threads, int smem, void* stream) {
  return launch_tile(fb_grouped_scaled_kernel, true, R, Q, S, cluster,
                     threads, smem, stream, fexp, fmax, statics, be_exp, cbi,
                     alphas, betas, R, Q, L, S, (S + 3) / 4 * 4, Lm1,
                     num_static, J);
}

extern "C" const char* fb_grouped_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
