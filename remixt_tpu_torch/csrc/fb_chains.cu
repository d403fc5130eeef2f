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
// chain's ~265 steps multiplies by one 504 KB (S x S) matrix before the
// next step can start, and a (chain, direction) pair gives only 46
// independent walks for 132 SMs.
//
// Design: fb_chains_kernel runs a cluster of C blocks (C <= 8, the portable
// cluster size) per (chain, direction). Block `rank` owns states [rank*per,
// rank*per + per), per a multiple of 4 and at most 128.
//   - Residency. A chain keeps one normal class along its length, so nearly
//     every non-breakend step of a chain uses one static class matrix. The
//     wrapper picks each chain's resident class (its most used non-cut
//     static class, -1 for none); before the first step each block copies
//     its column slice of it (S x per floats; the reverse direction the
//     transpose's, so that both run u . M on it) into shared memory with
//     16-byte cp.async from the padded statics (rows Sp, a multiple of 4).
//     Resident steps read shared memory only. A step of another static
//     class reads the same slice of the padded statics from L2, one 16-byte
//     load a row. A breakend step streams its matrix from device memory
//     (forward: 4-byte loads of a thread's 4 columns; reverse: a warp per
//     row of the block's contiguous rows), and the cluster's blocks
//     prefetch it into L2 a step ahead (cp.async.bulk.prefetch).
//   - The carry in registers. Warp 0 holds the block's slice of the carry,
//     a quad of states a lane. At the end of a step it sums the products'
//     partial sums in a fixed order, takes log(max(s, TINY)) + m (plus the
//     frame forward) and writes the output row; then it shifts the next
//     step's input (reverse: plus the frame) by the slice's maximum m_c and
//     pushes u_c = exp(x - m_c) into every peer's double-buffered copy of
//     u, and (m_c, sum(u_c), the next class) into every peer's statistics:
//     16-byte st.async stores into distributed shared memory that count
//     their bytes on the peer's transaction barrier (mbarrier). Warp 0
//     loads the next step's frame and class ahead.
//   - A step, for every thread: wait on the block's barrier for the step's
//     bytes (all of u and every peer's statistics); take m = max_c m_c and
//     the cut class's sum_c sum_c * exp(m_c - m) in a fixed order; compute
//     the block's slice of the product, a quad of columns a thread and row
//     groups over the rows, each thread's rows from one peer, so that the
//     peer's shift exp(m_c - m) scales the thread's sums once (a reverse
//     breakend step rescales u first); one block barrier. No cluster
//     barrier: a block pushes step s + 1 only after its reads of step s,
//     and a peer writes a buffer again only after those pushes reach it.
//   - No atomics and a fixed order in every reduction: two launches on the
//     same inputs give the same bits.
// Shared memory (chains_base_floats, and ops/fb_chains.py's twin): the
// slice S x per, u 2 x Sp, the statistics 2 x 8 x 4 and the two barriers,
// then the partial sums (row groups x per). At S=355, C=5 (per 72, 512
// threads, 25 row groups): 102,240 B of slice, 112,560 B a block, two
// blocks an SM. C=8 (per 48, 320 threads) takes 75,888 B, three blocks an
// SM. A cluster size whose slice does not fit a block (C < 3 at S=355) is
// refused.
// On the card (chip_smoke.py phase 2b, NVIDIA H100 80GB HBM3, 700 W) at
// C=5 it took 1.183 ms alone and 1.508 ms through its wrapper (the resident
// classes and padded statics in torch), against 3.06-3.30 ms for the
// earlier design of this file (statics from L2 every step, the exchange
// pulled across a cluster barrier); 0.972 ms alone with every breakend
// step made static. At C=5 the card holds 47 clusters at once, all 46 of
// the problem; at C=8 only 45, so one waits for a second wave (1.649 ms),
// and C=3, 4, 6, 7 hold 30-39 (1.70-1.95 ms). A step costs ~6.3-7.1K
// cycles at 1.995 GHz: ~3.1-3.9K the product with the common maximum and
// the block barrier (two blocks of an SM share its shared-memory
// bandwidth), ~2.3K warp 0's epilogue, shift and push, ~0.3K the
// exchange's wait (fb_chains.trace). It is latency-bound, ~12x off the
// 0.098 ms bytes bound.
//
// The scaled-linear variant, fb_chains_scaled_kernel, replaces the TPU
// kernel _fb_kernel_scaled (fb_pallas.py:260), the chain update of the
// single-restart fit under REMIXT_TPU_SCALED_LINEAR=1. It keeps the earlier
// design of this file: no residency, static and breakend matrices read
// from L2 or device memory with 4-byte loads, the exchanged slices pulled.
// It reads fexp = exp(frame - fmax) (Q, L, S) and fmax (Q, L) and keeps a
// linear carry normalised by its maximum, with a log scale beside it (see
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
// in torch (0.06 ms) included, against 3.10 ms for the earlier
// fb_chains_kernel in the same run (chip_smoke.py phase 2d, NVIDIA H100
// 80GB HBM3, 700 W): latency-bound, each thread issuing ~70 dependent
// loads from L2 a step.

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

// Shared memory of fb_chains_kernel before its partial sums, in floats:
// the resident slice (S x per), u (2 x Sp, Sp = S rounded up to a
// multiple of 4, so that quads of it are 16-byte aligned), the peers'
// statistics (2 x MAX_CLUSTER x 4) and the two exchange barriers (2 x 8
// bytes); the partial sums after them take 16-byte stores.
// ops/fb_chains.py counts the same in its chains_base_floats, and
// tests/test_torch_fb_chains.py holds the two, and the launcher's per and
// row groups, to the Python launch_plan.
__host__ __device__ inline size_t chains_base_floats(int S, int per) {
  return (size_t)S * per + (size_t)2 * ((S + 3) / 4 * 4)
      + 2 * MAX_CLUSTER * 4 + 4;
}

// A 16-byte copy from global to shared memory through L2 only, which
// holds no register while in flight; copy_async_wait waits for the calling
// thread's copies.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Asks L2 to fetch share `rank` of `C` of the n floats at M (16-byte
// aligned bytes within them): a bulk prefetch, which holds no register.
__device__ __forceinline__ void prefetch_share_l2(const float* M, size_t n,
                                                  int rank, int C) {
  const size_t a = (size_t)(M + n * rank / C) & ~(size_t)15;
  const size_t e = (size_t)(M + n * (rank + 1) / C) & ~(size_t)15;
  if (e > a)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 ::"l"(a), "r"((unsigned)(e - a)) : "memory");
}

// The exchange through distributed shared memory: a block stores into a
// peer's shared memory with st.async, which counts the bytes on the peer's
// transaction barrier (mbarrier); the peer arms its barrier with the bytes
// a step brings and waits for them. peer_addr is the address of p in block
// `rank`'s shared memory.
__device__ __forceinline__ unsigned peer_addr(const void* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void push4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr), "f"(v.x), "f"(v.y),
      "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(a), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of `parity` to complete; traps after
// about 2^22 tries rather than hang.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  for (int k = 0;; ++k) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (k > (1 << 22)) __trap();
  }
}

#ifdef FB_CHAINS_TRACE
// clock64 marks of a step's parts, compiled in only with -DFB_CHAINS_TRACE
// (ops/fb_chains.trace): for each (chain, direction) the cycles of each
// part summed over the steps, as thread 0 of the cluster's block 0 sees
// them, and the %globaltimer nanoseconds at the start and the end of its
// steps; fb_chains_trace_read copies them out. Parts: 0 warp 0's loads of
// the next step's frame and class, 1 the exchange's wait, 2 the common
// maximum, the product and the block barrier, 3 warp 0's epilogue, shift
// and push; 4-7 the number of cut, resident, other static and breakend
// steps; 8, 9 start and end.
constexpr int TRACE_PARTS = 10;
constexpr int TRACE_CHAINS = 64;
__device__ long long fb_chains_trace[2 * TRACE_CHAINS][TRACE_PARTS];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// The block's slice of u . M: columns [0, n_own) of M, whose rows are ld
// floats apart. A quad of 4 columns a thread (quad tid % (per / 4)) and G
// row groups, G / C of them for each peer's part of u, so that a thread's
// rows (tid / (per / 4) = c * G / C + k: rows c * per + k, k + G / C, ...)
// come from one peer c, whose shift exp(m_c - m) (stat[4c] the peer's
// maximum, m the common one) scales the thread's sums once. kAligned: M's
// address and ld are multiples of 4 floats (the resident slice in shared
// memory, the padded statics), one 16-byte load a row; else (a breakend
// matrix) 4-byte loads of the quad's own columns. Each row group writes
// its partial sums, a row of red (G x per floats, 16-byte aligned).
template <bool kAligned>
__device__ __forceinline__ void product_slice(const float* M, int ld,
                                              const float* u,
                                              const float* stat, float m,
                                              int S, int n_own, int per,
                                              int C, int G, float* red) {
  const int tid = threadIdx.x;
  const int quad = tid % (per / 4), g = tid / (per / 4);
  const int width = min(4, n_own - quad * 4);  // the quad's own columns
  const int Gc = G / C, c = g / Gc;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < G && width > 0) {
    const float* col = M + quad * 4;
    const int end = min(S, (c + 1) * per);
#pragma unroll 4
    for (int i = c * per + g % Gc; i < end; i += Gc) {
      const float* e = col + (size_t)i * ld;
      float4 w;
      if (kAligned) {
        w = *reinterpret_cast<const float4*>(e);
      } else {
        w.x = e[0];
        w.y = width > 1 ? e[1] : 0.f;
        w.z = width > 2 ? e[2] : 0.f;
        w.w = width > 3 ? e[3] : 0.f;
      }
      const float x = u[i];
      acc.x = fmaf(x, w.x, acc.x);
      acc.y = fmaf(x, w.y, acc.y);
      acc.z = fmaf(x, w.z, acc.z);
      acc.w = fmaf(x, w.w, acc.w);
    }
    const float sc = expf(stat[4 * c] - m);
    acc.x *= sc;
    acc.y *= sc;
    acc.z *= sc;
    acc.w *= sc;
  }
  if (g < G) *reinterpret_cast<float4*>(red + g * per + quad * 4) = acc;
}

// The block's slice of a breakend's M . u: its own rows, contiguous from
// M, a warp per row, into red[i] for own row i. u must be scaled to the
// common maximum.
__device__ __forceinline__ void bank_reverse(const float* M, const float* u,
                                             int S, int n_own, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < n_own; i += nwarps) {
    const float* row = M + (size_t)i * S;
    float s = 0.f;
#pragma unroll 8
    for (int j = lane; j < S; j += 32) s = fmaf(row[j], u[j], s);
    s = warp_sum(s);
    if (lane == 0) red[i] = s;
  }
}

// The lane's quad of a row of states [lo + 4k, lo + 4k + 4) from global
// memory, states past the slice (w <= the index) as `pad`.
__device__ __forceinline__ float4 load_quad(const float* row, int w,
                                            float pad) {
  return make_float4(row[0], w > 1 ? row[1] : pad, w > 2 ? row[2] : pad,
                     w > 3 ? row[3] : pad);
}

__device__ __forceinline__ void store_quad(float* row, int w, float4 v) {
  row[0] = v.x;
  if (w > 1) row[1] = v.y;
  if (w > 2) row[2] = v.z;
  if (w > 3) row[3] = v.w;
}

// frames (Q, L, S); statics (2, num_static, S, Sp): the static class
// matrices and their transposes, rows padded to Sp = a multiple of 4
// floats; be_exp (J, S, S); cbi (Q, Lm1) int32, value < num_static a
// static class, num_static + j breakend j; resident (Q,) int32, each
// chain's resident static class or -1; alphas, betas (Q, L, S). Grid
// (C, Q, 2) in clusters of (C, 1, 1); blockDim a multiple of 32, at least
// (per / 4) x G; per, a multiple of 4 and at most 128 (a quad a lane of
// warp 0), times C at least S; G, a multiple of C, the products' row
// groups; dynamic shared memory chains_base_floats(S, per) floats and red,
// G x per floats.
__global__ void __launch_bounds__(1024)
fb_chains_kernel(const float* __restrict__ frames,
                 const float* __restrict__ statics,
                 const float* __restrict__ be_exp,
                 const int* __restrict__ cbi,
                 const int* __restrict__ resident,
                 float* __restrict__ alphas, float* __restrict__ betas,
                 int L, int S, int Sp, int Lm1, int num_static, int per,
                 int G) {
  extern __shared__ float4 smem_chain[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int lo = rank * per;
  const int n_own = max(0, min(per, S - lo));

  // S x per: columns [lo, lo + per) of the resident class (reverse: of its
  // transpose), rows per floats apart
  float* slice = reinterpret_cast<float*>(smem_chain);
  // 2 x Sp: the shifted vector, double-buffered; the peers write it
  float* u = slice + (size_t)S * per;
  // 2 x MAX_CLUSTER x 4: every peer's (max, sum, class of the step) of its
  // slice; the peers write it
  float* stat = u + 2 * Sp;
  // the products' partial sums, after the two buffers' exchange barriers
  float* red = slice + chains_base_floats(S, per);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red) - 2;

  const size_t SS = (size_t)S * S, SSp = (size_t)S * Sp;
  const float* F = frames + (size_t)q * L * S + lo;
  float* out = (reverse ? betas : alphas) + (size_t)q * L * S + lo;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int res = resident[q];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // warp 0 keeps the carry, a quad of own states a lane (w of them own)
  const int w = n_own - 4 * lane;
  const bool owner = warp == 0 && w > 0;
  // the bytes a step brings a block: all of u, in quads, and every peer's
  // statistics
  const unsigned step_bytes = 4u * Sp + 16u * C;

  // the resident slice: whole quads of the own columns, in bounds of Sp
  if (res >= 0) {
    const int nq = (n_own + 3) / 4;
    const float* src =
        statics + ((size_t)reverse * num_static + res) * SSp + lo;
    for (int k = tid; k < S * nq; k += nt) {
      const int i = k / nq, c = k % nq;
      copy_async16(slice + (size_t)i * per + 4 * c,
                   src + (size_t)i * Sp + 4 * c);
    }
  }
  copy_async_wait();
  if (tid == 0) {
    bar_init(bars);
    bar_init(bars + 1);
  }
  // the carry: forward the first frame, reverse 0
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owner) {
    const size_t row = (size_t)(reverse ? L - 1 : 0) * S + 4 * lane;
    if (!reverse) carry = load_quad(F + row, w, 0.f);
    store_quad(out + row, w, carry);
  }
  // every block of the cluster runs, its slice copied and its barriers set
  // up, before a peer writes its shared memory
  cluster.sync();

  // warp 0: shift x (the carry, reverse plus the frame) by its maximum and
  // push it, and the maximum, sum and class b of step `step`, into every
  // peer; states past the slice push zeros
  auto shift_push = [&](int step, float4 x, int b) {
    const int buf = step & 1;
    if (!owner) x = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    if (w < 4) {
      x.w = -INFINITY;
      if (w < 3) x.z = -INFINITY;
      if (w < 2) x.y = -INFINITY;
    }
    const float m = warp_max(fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    if (lane == 0) bar_expect(bars + buf, step_bytes);
    float s = 0.f;
    if (owner) {
      const float4 e = make_float4(expf(x.x - m), expf(x.y - m),
                                   expf(x.z - m), expf(x.w - m));
      s = e.x + e.y + e.z + e.w;
      float* dst = u + buf * Sp + lo + 4 * lane;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < C) push4(peer_addr(dst, c), e, peer_addr(bars + buf, c));
    }
    s = warp_sum(s);
    if (lane < C)
      push4(peer_addr(stat + (buf * MAX_CLUSTER + rank) * 4, lane),
            make_float4(m, s, __int_as_float(b), 0.f),
            peer_addr(bars + buf, lane));
  };
  // the frame row the epilogue of the step at t needs: forward t's,
  // reverse the next step's (t - 1), loaded a step ahead
  auto frame_quad = [&](int row) {
    return owner ? load_quad(F + (size_t)row * S + 4 * lane, w, 0.f)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  if (warp == 0 && L > 1) {
    const int t = reverse ? L - 1 : 1;
    float4 x = carry;
    if (reverse) {
      const float4 f = frame_quad(t);
      x = make_float4(x.x + f.x, x.y + f.y, x.z + f.z, x.w + f.w);
    }
    shift_push(1, x, bidx[t - 1]);
  }
#ifdef FB_CHAINS_TRACE
  const bool traced = tid == 0 && rank == 0 && q < TRACE_CHAINS;
  // the marks add up in shared memory, copied out at the end
  __shared__ long long spent[TRACE_PARTS];
  long long mark = clock64();
  if (traced) {
    for (int k = 0; k < TRACE_PARTS; ++k) spent[k] = 0;
    spent[8] = global_ns();
  }
#define TRACE(k)                        \
  if (traced) {                         \
    const long long now = clock64();    \
    spent[k] += now - mark;             \
    mark = now;                         \
  }
#else
#define TRACE(k)
#endif

  for (int step = 1; step < L; ++step) {
    // forward: pair (t-1, t) produces position t from frame t;
    // reverse: pair (t-1, t) produces position t-1 from frame t
    const int t = reverse ? L - step : step;
    const int buf = step & 1;
    float* my_u = u + buf * Sp;
    const float* my_stat = stat + buf * MAX_CLUSTER * 4;
    const bool more = step + 1 < L;
    // warp 0 loads ahead what its epilogue needs: the frame row and the
    // class of the next step
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    int b_next = 0;
    if (warp == 0) {
      if (!reverse || more) f = frame_quad(reverse ? t - 1 : t);
      if (more) b_next = bidx[(reverse ? t - 1 : t + 1) - 1];
    }
    TRACE(0);
    bar_wait(bars + buf, ((step - 1) >> 1) & 1);
    TRACE(1);

    // the common maximum, the cut class's sum and the class, in the peers'
    // order
    float m = -INFINITY, total = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < C) m = fmaxf(m, my_stat[4 * c]);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < C)
        total = fmaf(my_stat[4 * c + 1], expf(my_stat[4 * c] - m), total);
    const int b = __float_as_int(my_stat[2]);
#ifdef FB_CHAINS_TRACE
    const int kind = b == 0 ? 0 : b == res ? 1 : b < num_static ? 2 : 3;
    if (traced) spent[4 + kind] += 1;
#endif

    // the product's partial sums, G rows of red (a reverse breakend: 1)
    int rows = G;
    if (b == 0) {
      rows = 0;
    } else if (b == res) {
      product_slice<true>(slice, per, my_u, my_stat, m, S, n_own, per, C, G,
                          red);
    } else if (b < num_static) {
      // reverse: M . u is u . M^T, columns of the transposed matrix
      product_slice<true>(
          statics + ((size_t)reverse * num_static + b) * SSp + lo, Sp, my_u,
          my_stat, m, S, n_own, per, C, G, red);
    } else {
      const float* M = be_exp + (size_t)(b - num_static) * SS;
      if (!reverse) {
        product_slice<false>(M + lo, S, my_u, my_stat, m, S, n_own, per, C,
                             G, red);
      } else {
        // every peer's part of u to the common maximum
        for (int i = tid; i < S; i += nt) {
          const int c = i / per;
          my_u[i] *= expf(my_stat[4 * c] - m);
        }
        __syncthreads();
        bank_reverse(M + (size_t)lo * S, my_u, S, n_own, red);
        rows = 1;
      }
    }
    // the partial sums are written, and every read of u and the statistics
    // of this step is done before warp 0 lets the peers reuse them
    __syncthreads();
    TRACE(2);

    if (warp == 0) {
      // the step's result: its rows of partial sums, in a fixed order
      float4 s = make_float4(total, total, total, total);
      if (rows > 0 && owner) {
        s = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4* part = reinterpret_cast<const float4*>(red) + lane;
        for (int g = 0; g < rows; ++g) {
          const float4 p = part[g * (per / 4)];
          s.x += p.x;
          s.y += p.y;
          s.z += p.z;
          s.w += p.w;
        }
      }
      carry = make_float4(logf(fmaxf(s.x, TINY)) + m,
                          logf(fmaxf(s.y, TINY)) + m,
                          logf(fmaxf(s.z, TINY)) + m,
                          logf(fmaxf(s.w, TINY)) + m);
      float4 x = carry;
      if (!reverse) {
        carry = x = make_float4(x.x + f.x, x.y + f.y, x.z + f.z, x.w + f.w);
      } else {
        x = make_float4(x.x + f.x, x.y + f.y, x.z + f.z, x.w + f.w);
      }
      if (owner)
        store_quad(out + (size_t)(reverse ? t - 1 : t) * S + 4 * lane, w,
                   carry);
      // the next step's breakend matrix: the cluster's blocks prefetch a
      // share of it each into L2
      if (lane == 0 && b_next >= num_static)
        prefetch_share_l2(be_exp + (size_t)(b_next - num_static) * SS, SS,
                          rank, C);
      if (more) shift_push(step + 1, x, b_next);
    }
    TRACE(3);
  }
#ifdef FB_CHAINS_TRACE
  if (traced) {
    spent[9] = global_ns();
    for (int k = 0; k < TRACE_PARTS; ++k)
      fb_chains_trace[2 * q + reverse][k] = spent[k];
  }
#endif
#undef TRACE
  // no block may leave while a peer can still write its shared memory
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

// Grid (cluster, Q, 2) in clusters of `cluster` blocks of `threads`,
// `smem` bytes of dynamic shared memory: chains_base_floats and red, the
// products' partial sums of as many row groups as fit, the same number for
// each peer, at least one.
extern "C" int fb_chains_launch(const float* frames, const float* statics,
                                const float* be_exp, const int* cbi,
                                const int* resident, float* alphas,
                                float* betas, int Q, int L, int S, int Lm1,
                                int num_static, int cluster, int threads,
                                int smem, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int per = ((S + cluster - 1) / cluster + 3) / 4 * 4;
  if (threads % 32 != 0 || threads > 1024 || per > 128)
    return (int)cudaErrorInvalidValue;
  const size_t base = chains_base_floats(S, per);
  if (smem < 0 || (size_t)smem < base * sizeof(float))
    return (int)cudaErrorInvalidValue;
  const size_t red = smem / sizeof(float) - base;
  const int Gc = (int)min((size_t)min(threads / (per / 4) / cluster, per),
                          red / ((size_t)per * cluster));
  if (Gc < 1) return (int)cudaErrorInvalidValue;
  return launch(fb_chains_kernel, smem, Q, cluster, threads, stream, frames,
                statics, be_exp, cbi, resident, alphas, betas, L, S,
                (S + 3) / 4 * 4, Lm1, num_static, per, Gc * cluster);
}

// How many clusters of fb_chains_kernel the card holds at once at this
// cluster size, block and shared memory (cudaOccupancyMaxActiveClusters).
extern "C" int fb_chains_max_active_clusters(int cluster, int threads,
                                             int smem, int* clusters) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fb_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 2);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)fb_chains_kernel, &cfg);
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

#ifdef FB_CHAINS_TRACE
// The marks of the last traced launch (see fb_chains_trace), 2 x
// TRACE_CHAINS x TRACE_PARTS counts.
extern "C" int fb_chains_trace_read(long long* parts) {
  return (int)cudaMemcpyFromSymbol(parts, fb_chains_trace,
                                   sizeof(fb_chains_trace));
}
#endif

extern "C" const char* fb_chains_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
