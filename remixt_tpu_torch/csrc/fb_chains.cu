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
// single-restart fit under REMIXT_TPU_SCALED_LINEAR=1. It reads fexp =
// exp(frame - fmax) (Q, L, S) and fmax (Q, L), made by the wrapper, and
// keeps a linear vector normalised by its maximum, with a log scale beside
// it (see fb_grouped.cu):
//   forward s = (u . M) * fexp[t], reverse s = M . (u * fexp[t]) (the cut
//   class sums), m = max(max(s), TINY), u = s / m, scale += log(m) +
//   fmax[t], and the message log(max(u, TINY)) + scale.
// It runs on fb_chains_kernel's clusters, slices, shared memory and
// exchange: the resident class in shared memory, the other classes and
// the breakend matrices as there, st.async pushes counted on mbarriers,
// one block barrier a step and no cluster barrier. What differs is that
// the normaliser m is the maximum of the step's new product over all S
// states, known only after the exchange, so a block pushes its slice of
// the product rather than of its input:
//   - At the end of a step warp 0 holds the block's slice s_c of the
//     product (forward already times its fexp[t] quad, loaded a step
//     ahead), takes its maximum m_c, and pushes into every peer
//     p_c = s_c / max(m_c, TINY) (reverse: times fexp[t - 1], which the
//     next product folds in), with (m_c, sum(p_c), the next class).
//   - After the wait every block takes m = max(max_c m_c, TINY) in the
//     peers' order, so all see the same m and keep the same scale. Peer
//     c's part of the input is p_c * max(m_c, TINY) / m: product_slice
//     folds that factor into the thread's sums, where fb_chains_kernel
//     folds exp(m_c - m), and the cut class is sum_c sum(p_c) times it.
//     p_c lies in [0, 1] whatever m is, so the product never runs on
//     subnormal inputs, and no pass rescales u before it (a reverse
//     breakend step excepted, as in fb_chains_kernel).
//   - The message of step t's product needs m, so warp 0 keeps s_c in
//     registers and writes its row log(max(s_c / m, TINY)) + scale one
//     step late, after the next exchange, and after its own push of that
//     step, so that the peers do not wait for the row. The first vector
//     (forward fexp[0], reverse 1) goes through the same push, and a
//     closing push of the statistics alone gives the last row its m.
// What bounds it is what bounds fb_chains_kernel: 0.330 GB moved once,
// 0.098 ms at 3.35 TB/s, above the fp32 3.05 GFLOP (0.046 ms), far below
// the latency of the serial chain. At C=5 (the card holds 47 of its
// clusters, all 46 of the problem; 30-45 at the other sizes) it took
// 1.31-1.43 ms through its wrapper, the frame shift in torch included, and
// 1.10-1.11 ms alone, against 3.00-3.05 ms in the same call for the
// earlier design of this kernel (every static matrix streamed from L2 with
// 4-byte loads, the peers' slices pulled across a cluster barrier); 0.88
// ms alone with every breakend step made static (chip_smoke.py phase 2d,
// NVIDIA H100 80GB HBM3, 700.00 W). A step costs ~6.7-8.2K cycles at 1.99
// GHz: ~2.9-4.0K the common maximum, product and block barrier, ~2.7-2.9K
// warp 0's epilogue, push and row, ~0.3K the exchange's wait
// (fb_chains.trace). It is latency-bound, ~11x off the bound alone.

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

// Shared memory of both kernels before their partial sums, in floats:
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
// what its epilogue needs, 1 the exchange's wait, 2 the common maximum,
// the product and the block barrier, 3 warp 0's epilogue and push; 4-7 the
// number of cut, resident, other static and breakend steps; 8, 9 start
// and end. Either kernel writes them.
constexpr int TRACE_PARTS = 10;
constexpr int TRACE_CHAINS = 64;
__device__ long long fb_chains_trace[2 * TRACE_CHAINS][TRACE_PARTS];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The marks add up in shared memory, copied out at the end.
#define TRACE_OPEN                                                  \
  __shared__ long long spent[TRACE_PARTS];                          \
  const bool traced = tid == 0 && rank == 0 && q < TRACE_CHAINS;    \
  long long mark = clock64();                                       \
  if (traced) {                                                     \
    for (int k = 0; k < TRACE_PARTS; ++k) spent[k] = 0;             \
    spent[8] = global_ns();                                         \
  }
#define TRACE(k)                        \
  if (traced) {                         \
    const long long now = clock64();    \
    spent[k] += now - mark;             \
    mark = now;                         \
  }
#define TRACE_KIND(b)                                                   \
  if (traced)                                                           \
    spent[4 + ((b) == 0 ? 0 : (b) == res ? 1 : (b) < num_static ? 2 : 3)] \
        += 1;
#define TRACE_CLOSE                                     \
  if (traced) {                                         \
    spent[9] = global_ns();                             \
    for (int k = 0; k < TRACE_PARTS; ++k)               \
      fb_chains_trace[2 * q + reverse][k] = spent[k];   \
  }
#else
#define TRACE_OPEN
#define TRACE(k)
#define TRACE_KIND(b)
#define TRACE_CLOSE
#endif

// The block's slice of u . M: columns [0, n_own) of M, whose rows are ld
// floats apart. A quad of 4 columns a thread (quad tid % (per / 4)) and G
// row groups, G / C of them for each peer's part of u, so that a thread's
// rows (tid / (per / 4) = c * G / C + k: rows c * per + k, k + G / C, ...)
// come from one peer c, whose factor scale(c) (fb_chains_kernel: the
// peer's shift exp(m_c - m); fb_chains_scaled_kernel: its normaliser
// max(m_c, TINY) / m) scales the thread's sums once. kAligned: M's
// address and ld are multiples of 4 floats (the resident slice in shared
// memory, the padded statics), one 16-byte load a row; else (a breakend
// matrix) 4-byte loads of the quad's own columns. Each row group writes
// its partial sums, a row of red (G x per floats, 16-byte aligned).
template <bool kAligned, typename Scale>
__device__ __forceinline__ void product_slice(const float* M, int ld,
                                              const float* u, Scale scale,
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
    const float sc = scale(c);
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

// The block's slice of a step's product with class b (not the cut class)
// into red, from the input u whose part from peer c scale(c) scales:
// the resident slice, the padded statics (reverse: their transposes, as
// u . M^T) or breakend matrix b - num_static. Returns the rows of partial
// sums it wrote. A reverse breakend step scales u in place first, behind
// a block barrier, which every thread reaches since b is the block's.
template <typename Scale>
__device__ __forceinline__ int step_product(
    int b, int res, bool reverse, const float* slice, const float* statics,
    const float* be_exp, float* u, Scale scale, int S, int Sp, int lo,
    int n_own, int per, int C, int G, int num_static, float* red) {
  if (b == res) {
    product_slice<true>(slice, per, u, scale, S, n_own, per, C, G, red);
  } else if (b < num_static) {
    product_slice<true>(
        statics + ((size_t)reverse * num_static + b) * S * Sp + lo, Sp, u,
        scale, S, n_own, per, C, G, red);
  } else {
    const float* M = be_exp + (size_t)(b - num_static) * S * S;
    if (!reverse) {
      product_slice<false>(M + lo, S, u, scale, S, n_own, per, C, G, red);
    } else {
      // every peer's part of u to the common maximum
      for (int i = threadIdx.x; i < S; i += blockDim.x) u[i] *= scale(i / per);
      __syncthreads();
      bank_reverse(M + (size_t)lo * S, u, S, n_own, red);
      return 1;
    }
  }
  return G;
}

// Warp 0's quad of a step's product: its `rows` rows of partial sums, in a
// fixed order.
__device__ __forceinline__ float4 sum_rows(const float* red, int rows,
                                           int per, int lane) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* part = reinterpret_cast<const float4*>(red) + lane;
  for (int g = 0; g < rows; ++g) {
    const float4 p = part[g * (per / 4)];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  return s;
}

// Before the first step: the block's column slice of the chain's resident
// class res (reverse: of its transpose, so that both directions run u . M
// on it), whole quads of the own columns in bounds of Sp, copied with
// 16-byte cp.async into slice (S x per); thread 0 sets up the two exchange
// barriers. A cluster barrier must follow before any peer writes the
// block's shared memory.
__device__ __forceinline__ void load_resident(
    float* slice, const float* statics, int res, bool reverse,
    int num_static, int S, int Sp, int lo, int n_own, int per,
    unsigned long long* bars) {
  if (res >= 0) {
    const int nq = (n_own + 3) / 4;
    const float* src =
        statics + ((size_t)reverse * num_static + res) * S * Sp + lo;
    for (int k = threadIdx.x; k < S * nq; k += blockDim.x) {
      const int i = k / nq, c = k % nq;
      copy_async16(slice + (size_t)i * per + 4 * c,
                   src + (size_t)i * Sp + 4 * c);
    }
  }
  copy_async_wait();
  if (threadIdx.x == 0) {
    bar_init(bars);
    bar_init(bars + 1);
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

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// v with the states past the slice (w <= the index) zero.
__device__ __forceinline__ float4 own_quad(float4 v, int w) {
  return make_float4(w > 0 ? v.x : 0.f, w > 1 ? v.y : 0.f,
                     w > 2 ? v.z : 0.f, w > 3 ? v.w : 0.f);
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

  const float* F = frames + (size_t)q * L * S + lo;
  float* out = (reverse ? betas : alphas) + (size_t)q * L * S + lo;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int res = resident[q];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // warp 0 keeps the carry, a quad of own states a lane (w of them own)
  const int w = n_own - 4 * lane;
  const bool owner = warp == 0 && w > 0;
  // the bytes a step brings a block: all of u, in quads, and every peer's
  // statistics
  const unsigned step_bytes = 4u * Sp + 16u * C;

  load_resident(slice, statics, res, reverse, num_static, S, Sp, lo, n_own,
                per, bars);
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
  TRACE_OPEN

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
    TRACE_KIND(b);

    // the product's partial sums, rows of red (none for the cut class)
    const int rows =
        b == 0 ? 0
               : step_product(
                     b, res, reverse, slice, statics, be_exp, my_u,
                     [&](int c) { return expf(my_stat[4 * c] - m); }, S, Sp,
                     lo, n_own, per, C, G, num_static, red);
    // the partial sums are written, and every read of u and the statistics
    // of this step is done before warp 0 lets the peers reuse them
    __syncthreads();
    TRACE(2);

    if (warp == 0) {
      // the step's result: its rows of partial sums, in a fixed order
      float4 s = make_float4(total, total, total, total);
      if (rows > 0 && owner) s = sum_rows(red, rows, per, lane);
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
        prefetch_share_l2(be_exp + (size_t)(b_next - num_static) * S * S,
                          (size_t)S * S, rank, C);
      if (more) shift_push(step + 1, x, b_next);
    }
    TRACE(3);
  }
  TRACE_CLOSE
  // no block may leave while a peer can still write its shared memory
  cluster.sync();
}

// The scaled-linear kernel: fexp (Q, L, S) = exp(frame - fmax), fmax
// (Q, L); the other arguments, grid, clusters and shared memory as
// fb_chains_kernel's.
__global__ void __launch_bounds__(1024)
fb_chains_scaled_kernel(const float* __restrict__ fexp,
                        const float* __restrict__ fmax,
                        const float* __restrict__ statics,
                        const float* __restrict__ be_exp,
                        const int* __restrict__ cbi,
                        const int* __restrict__ resident,
                        float* __restrict__ alphas, float* __restrict__ betas,
                        int L, int S, int Sp, int Lm1, int num_static,
                        int per, int G) {
  extern __shared__ float4 smem_chain[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const int lo = rank * per;
  const int n_own = max(0, min(per, S - lo));

  // fb_chains_kernel's layout; u holds the pushed slices p_c, stat every
  // peer's (m_c, sum(p_c), class of the step)
  float* slice = reinterpret_cast<float*>(smem_chain);
  float* u = slice + (size_t)S * per;
  float* stat = u + 2 * Sp;
  float* red = slice + chains_base_floats(S, per);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red) - 2;

  const float* E = fexp + (size_t)q * L * S + lo;
  const float* FM = fmax + (size_t)q * L;
  float* out = (reverse ? betas : alphas) + (size_t)q * L * S + lo;
  const int* bidx = cbi + (size_t)q * Lm1;
  const int res = resident[q];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // warp 0 keeps the block's slice of the product, a quad of own states a
  // lane (w of them own)
  const int w = n_own - 4 * lane;
  const bool owner = warp == 0 && w > 0;
  const unsigned step_bytes = 4u * Sp + 16u * C;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  load_resident(slice, statics, res, reverse, num_static, S, Sp, lo, n_own,
                per, bars);
  cluster.sync();

  // the lane's quad of fexp row `row`, 0 past the slice
  auto frame_quad = [&](int row) {
    return owner ? load_quad(E + (size_t)row * S + 4 * lane, w, 0.f) : zero;
  };
  // warp 0: push the block's slice s of a product (0 past the slice) for
  // step `step`: p = s / max(m_c, TINY), reverse times the next product's
  // frame quad f, into every peer's u, and (m_c, sum(p), class b) into
  // every peer's statistics; with `full` false the statistics alone
  auto publish = [&](int step, float4 s, float4 f, int b, bool full) {
    const int buf = step & 1;
    const float mc = warp_max(fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w)));
    if (lane == 0) bar_expect(bars + buf, full ? step_bytes : 16u * C);
    float sum = 0.f;
    if (full && owner) {
      const float r = 1.f / fmaxf(mc, TINY);
      float4 p = make_float4(s.x * r, s.y * r, s.z * r, s.w * r);
      if (reverse) p = mul4(p, f);
      sum = p.x + p.y + p.z + p.w;
      float* dst = u + buf * Sp + lo + 4 * lane;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < C) push4(peer_addr(dst, c), p, peer_addr(bars + buf, c));
    }
    sum = warp_sum(sum);
    if (lane < C)
      push4(peer_addr(stat + (buf * MAX_CLUSTER + rank) * 4, lane),
            make_float4(mc, sum, __int_as_float(b), 0.f),
            peer_addr(bars + buf, lane));
  };

  // warp 0's slice of the last product, raw, and the scale before it: the
  // first vector is forward fexp[0] at scale fmax[0], reverse 1 at scale 0
  float4 s = zero;
  float scale = 0.f;
  if (warp == 0) {
    float4 f = zero;
    if (reverse) {
      s = own_quad(make_float4(1.f, 1.f, 1.f, 1.f), w);
      if (L > 1) f = frame_quad(L - 1);
    } else {
      s = frame_quad(0);
    }
    publish(1, s, f, L > 1 ? bidx[reverse ? L - 2 : 0] : 0, L > 1);
  }
  TRACE_OPEN

  // step L only writes the last row
  for (int step = 1; step <= L; ++step) {
    // the step's product: forward pair (t-1, t) gives position t, reverse
    // position t-1, each from frame t
    const int t = reverse ? L - step : step;
    const int buf = step & 1;
    float* my_u = u + buf * Sp;
    const float* my_stat = stat + buf * MAX_CLUSTER * 4;
    const bool last = step == L, more = step + 1 < L;
    // warp 0 loads ahead what its epilogue needs: the fmax of the last
    // product's position, the frame quad of this product (reverse: of the
    // next, which the push folds in) and the class of the next step
    float fm = 0.f;
    float4 f = zero;
    int b_next = 0;
    if (warp == 0) {
      if (!reverse) {
        fm = FM[step - 1];
      } else if (step > 1) {
        fm = FM[t + 1];
      }
      if (reverse ? more : !last) f = frame_quad(reverse ? t - 1 : t);
      if (more) b_next = bidx[(reverse ? t - 1 : t + 1) - 1];
    }
    TRACE(0);
    bar_wait(bars + buf, ((step - 1) >> 1) & 1);
    TRACE(1);

    // the common normaliser and the class, in the peers' order
    float mx = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < C) mx = fmaxf(mx, my_stat[4 * c]);
    const float m = fmaxf(mx, TINY);
    // peer c's part of the input is its pushed slice times this
    auto factor = [&](int c) { return fmaxf(my_stat[4 * c], TINY) / m; };
    const int b = __float_as_int(my_stat[2]);
    int rows = 0;
    if (!last) {
      TRACE_KIND(b);
      if (b != 0)
        rows = step_product(b, res, reverse, slice, statics, be_exp, my_u,
                            factor, S, Sp, lo, n_own, per, C, G, num_static,
                            red);
    }
    // as in fb_chains_kernel: the partial sums are written and every read
    // of the step's buffers is done before warp 0 pushes the next step
    __syncthreads();
    TRACE(2);

    if (warp == 0) {
      // the last product's slice: its row is written after the push, off
      // the peers' path
      const float4 prev = s;
      if (!last) {
        // this step's slice: its rows of partial sums in a fixed order, or
        // the cut class's sum of the input
        if (rows > 0) {
          s = owner ? sum_rows(red, rows, per, lane) : zero;
        } else {
          float total = 0.f;
#pragma unroll
          for (int c = 0; c < MAX_CLUSTER; ++c)
            if (c < C) total = fmaf(my_stat[4 * c + 1], factor(c), total);
          s = make_float4(total, total, total, total);
        }
        if (!reverse) s = mul4(s, f);
        s = own_quad(s, w);
        if (lane == 0 && b_next >= num_static)
          prefetch_share_l2(be_exp + (size_t)(b_next - num_static) * S * S,
                            (size_t)S * S, rank, C);
        publish(step + 1, s, f, b_next, more);
      }
      // the last product's row, now that its normaliser is known
      scale = scale + logf(m) + fm;
      const float inv = 1.f / m;
      if (owner)
        store_quad(out + (size_t)(reverse ? t : t - 1) * S + 4 * lane, w,
                   make_float4(logf(fmaxf(prev.x * inv, TINY)) + scale,
                               logf(fmaxf(prev.y * inv, TINY)) + scale,
                               logf(fmaxf(prev.z * inv, TINY)) + scale,
                               logf(fmaxf(prev.w * inv, TINY)) + scale));
    }
    TRACE(3);
  }
  TRACE_CLOSE
  // no block may leave while a peer can still write its shared memory
  cluster.sync();
}

// Either kernel on grid (cluster, Q, 2) in clusters of `cluster` blocks.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int Q, int cluster, int threads, int smem, void* stream) {
    cfg.gridDim = dim3(cluster, Q, 2);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches either kernel, with its input pointers `ptrs` before the
// outputs' sizes, in clusters of `cluster` blocks of `threads` and `smem`
// bytes of dynamic shared memory: chains_base_floats and red, the
// products' partial sums of as many row groups as fit, the same number for
// each peer, at least one.
template <typename Kernel, typename... Ptrs>
int launch_chains(Kernel kernel, int Q, int L, int S, int Lm1,
                  int num_static, int cluster, int threads, int smem,
                  void* stream, Ptrs... ptrs) {
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
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(Q, cluster, threads, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, ptrs..., L, S,
                           (S + 3) / 4 * 4, Lm1, num_static, per,
                           Gc * cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Kernel>
int max_active(Kernel kernel, int cluster, int threads, int smem,
               int* clusters) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(1, cluster, threads, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                             &launch.cfg);
}

}  // namespace

extern "C" int fb_chains_launch(const float* frames, const float* statics,
                                const float* be_exp, const int* cbi,
                                const int* resident, float* alphas,
                                float* betas, int Q, int L, int S, int Lm1,
                                int num_static, int cluster, int threads,
                                int smem, void* stream) {
  return launch_chains(fb_chains_kernel, Q, L, S, Lm1, num_static, cluster,
                       threads, smem, stream, frames, statics, be_exp, cbi,
                       resident, alphas, betas);
}

extern "C" int fb_chains_scaled_launch(const float* fexp, const float* fmax,
                                       const float* statics,
                                       const float* be_exp, const int* cbi,
                                       const int* resident, float* alphas,
                                       float* betas, int Q, int L, int S,
                                       int Lm1, int num_static, int cluster,
                                       int threads, int smem, void* stream) {
  return launch_chains(fb_chains_scaled_kernel, Q, L, S, Lm1, num_static,
                       cluster, threads, smem, stream, fexp, fmax, statics,
                       be_exp, cbi, resident, alphas, betas);
}

// How many clusters of the log-space kernel (or with `scaled` the scaled
// one) the card holds at once at this cluster size, block and shared
// memory (cudaOccupancyMaxActiveClusters).
extern "C" int fb_chains_max_active_clusters(int scaled, int cluster,
                                             int threads, int smem,
                                             int* clusters) {
  return scaled ? max_active(fb_chains_scaled_kernel, cluster, threads, smem,
                             clusters)
                : max_active(fb_chains_kernel, cluster, threads, smem,
                             clusters);
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
