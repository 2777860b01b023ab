// Hopper (sm_90a) kernels for the windowed assignment solve.
//
// Replaces the two Pallas TPU kernels of traceweaver_tpu/ops/pallas_sinkhorn.py:
//   - fused_assign_kernel  <- _fused_kernel / fused_assign_pallas
//     (log-domain Sinkhorn, then greedy mutual-best rounding with a
//     capacity-limited skip column, then the top-k peel);
//   - sinkhorn_plan_kernel <- _kernel / sinkhorn_log_pallas
//     (the same Sinkhorn loop, writing the full transport plan).
// round_topk_kernel runs the fused kernel's rounding and peel code on a
// plan given in device memory, so that stage can be held bit for bit
// against the plain PyTorch rounding.
//
// Each kernel that reads scores is a template on the score type: float, or
// __nv_bfloat16 for the bf16 score path (Pallas bodies :88-94 and :237-241
// keep a bf16 block at storage precision and upcast it on each use). The
// tile ring carries the stored type, so a bf16 block streams half the
// bytes; every use upcasts to f32 and scales by 1/eps, and the
// potentials, column partials, plan and rounding state stay f32.
//
// What bounds it on this card: the work is one [R, C] f32 score block per
// window (R = W + 1 rows with the dummy row, C = M + 1 columns with the
// skip column; 8.4 MB at 1025 x 2049). Each Sinkhorn half-iteration does
// one exp per element (about 2.7e8 per iteration at B = 8). Exponentials
// go through the special-function units (16 per clock per SM), so they,
// not the bytes and not the other f32 operations, set the bound (about
// 0.33 ms for 40 iterations at B = 8). The block does not fit in shared
// memory, and B blocks (67 MB at B = 8) do not fit in the 50 MB L2, so it
// streams from HBM once per iteration (about 20 us at B = 8).
//
// What the design does about it: one thread-block cluster of G CTAs of
// 512 threads (G = 8 or 16, chosen by the wrapper from the card's cluster
// occupancy) per window, so a window's work spreads over G SMs instead of
// one. CTA r of the cluster owns the row stripe [r*RS, (r+1)*RS), RS =
// ceil(R/G), and keeps its phi, its rows' rounding state and a full copy
// of psi in shared memory:
//   - Sinkhorn, one read of the stripe per iteration: the stripe streams
//     through a two-slot ring of TR-row tiles in shared memory, each tile
//     one bulk (TMA) copy completing on an mbarrier, the next in flight
//     while this one is used, across iteration boundaries too. A tile's
//     rows get their phi update from psi (16/TR warps per row, 8 loads
//     folded at a time into an online log-sum-exp, two chains per lane),
//     then the same tile adds its rows, with the new phi, to per-column
//     partial (max, sum-exp) pairs (a thread per column, two at a time).
//     The exponentials run in base 2 on the special-function unit
//     (ex2.approx) on (x - max) * log2(e), while x, the running max and
//     the potentials stay in natural units, as in the plain version;
//   - after a cluster barrier CTA r merges the G partials of its column
//     slice [r*CS, (r+1)*CS), CS = ceil(C/G), read through distributed
//     shared memory (a lane per peer, butterfly merge, so every lane
//     holds the same bits), and writes psi of the slice into every
//     peer's copy; a second barrier ends the iteration;
//   - the tolerance exit reads the cluster-wide max |delta phi| after
//     the barrier, so every CTA takes the same break;
//   - rounding: the row argmax and the top-k peel stay stripe-local; the
//     wanted columns and the skip contenders' masses are written into
//     every peer's shared memory, each CTA forms partial column argmaxes
//     over its stripe, and a row reads the G partials of its column
//     (ties to the lower row index, as torch.argmax); taken columns, the
//     skip budget and the "any commit" flag are cluster-consistent after
//     each round's third barrier; a last barrier keeps every CTA alive
//     until its peers have stopped reading its shared memory. Its loops
//     fold 8 loads at a time, so each thread keeps 8 in flight.
// What holds it back now: each tile's two phases (row update, then column
// partials) take several times the cycles their exponentials need on the
// SFU, and HBM is not the limit either; overlapping the two phases in
// separate warp groups, more chains per lane and tree reductions did not
// change the time per element, so the cause is still to be measured.
//
// Plan entries are formed with __fmul_rn/__fadd_rn (never contracted into
// an FMA) as S / eps + (phi + psi), the plain version's association, and
// K1, K2 and round_topk run one cluster size for one (B, R, C), so the
// fused kernel's on-the-fly plan equals the plan the plain Sinkhorn
// kernel writes, bit for bit.
//
// Why natural units: a window with a live row (or column) whose every
// entry is masked lifts that potential to about -NEG = 1e9, where f32
// values are 64 apart, and the masked entries of its row (column) come
// out of S + psi (S + phi) as values of order 64, the same in every
// implementation that forms S + psi in f32 and subtracts the max before
// the exponential (XLA's, ATen's on the CPU and on the card). Scaling x
// by log2(e) before the max rounds those values differently, and the
// window's plan then parts from the plain version's; such windows are a
// head and a tail of every stream window.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TW_THREADS 512
#define TW_WARPS (TW_THREADS / 32)
#define TW_MAX_TOPK 16
#define TW_FULL 0xffffffffu
#define TW_BATCH 8

static const float kNeg = -1.0e9f;

// row flags of one rounding round
#define F_ACTIVE 1
#define F_WANTS_SKIP 2
#define F_CONTENDER 4

__device__ __forceinline__ float log_marginal(float m) {
  return m > 0.f ? logf(fmaxf(m, 1e-30f)) : kNeg;
}

__device__ __forceinline__ float plan_val(float s, float inv_eps, float phi,
                                          float psi) {
  float x = __fadd_rn(__fmul_rn(s, inv_eps), __fadd_rn(phi, psi));
  return expf(fminf(fmaxf(x, -80.f), 80.f));
}

// a stored score as f32 (the bf16 upcast is exact)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

static const float kLog2e = 1.4426950408889634f;
static const float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (about 2 ulp; flushes subnormals).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^d for a difference d = x - max (natural units): the difference is
// taken before the scaling, so a large x and its max cancel exactly
__device__ __forceinline__ float exd(float d) { return ex2(__fmul_rn(d, kLog2e)); }

// Online log-sum-exp: m = running max, s = sum of e^(x - m), both of
// natural-unit x. lse_batch folds a batch whose x[0] is finite (padding
// is -inf).
__device__ __forceinline__ void lse_batch(float &m, float &s,
                                          const float (&x)[TW_BATCH]) {
  float bm = x[0];
#pragma unroll
  for (int q = 1; q < TW_BATCH; ++q) bm = fmaxf(bm, x[q]);
  if (bm > m) {
    s *= exd(m - bm);
    m = bm;
  }
#pragma unroll
  for (int q = 0; q < TW_BATCH; ++q) s += exd(x[q] - m);
}

__device__ __forceinline__ void lse_push(float &m, float &s, float x) {
  if (x > m) {
    s = __fmaf_rn(s, exd(m - x), 1.f);
    m = x;
  } else {
    s += exd(x - m);
  }
}

// Merge two (max, sum) pairs; commutative bit for bit.
__device__ __forceinline__ void lse_merge(float &m, float &s, float m2,
                                          float s2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2;
    s = s2;
    return;
  }
  if (m2 > m) {
    s = __fmaf_rn(s, exd(m - m2), s2);
    m = m2;
  } else {
    s = __fmaf_rn(s2, exd(m2 - m), s);
  }
}

// log-sum-exp of a (max, sum) pair
__device__ __forceinline__ float lse_ln(float m, float s) {
  return __fadd_rn(m, __fmul_rn(log2f(s), kLn2));
}

// butterfly merge over aligned groups of `width` lanes (every lane of a
// group ends with the same bits, since lse_merge is commutative)
__device__ __forceinline__ void group_lse(float &m, float &s, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    float m2 = __shfl_xor_sync(TW_FULL, m, off);
    float s2 = __shfl_xor_sync(TW_FULL, s, off);
    lse_merge(m, s, m2, s2);
  }
}

// (value, index) argmax: larger value wins, equal values keep the lower
// index (first occurrence, as jnp.argmax / torch.argmax)
__device__ __forceinline__ void warp_argmax(float &v, int &idx) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(TW_FULL, v, off);
    int i2 = __shfl_xor_sync(TW_FULL, idx, off);
    if (v2 > v || (v2 == v && i2 < idx)) {
      v = v2;
      idx = i2;
    }
  }
}

// Where one CTA sits in its window's cluster.
struct Geo {
  int rank, G;  // CTA rank in the cluster, cluster size
  int r0, r1;   // owned row stripe [r0, r1) (may be empty)
  int c0, c1;   // column slice merged by this CTA
};

__device__ inline Geo geometry(cg::cluster_group cl, int R, int C) {
  Geo g;
  g.rank = (int)cl.block_rank();
  g.G = (int)cl.num_blocks();
  const int rs = (R + g.G - 1) / g.G, cs = (C + g.G - 1) / g.G;
  g.r0 = min(g.rank * rs, R);
  g.r1 = min(g.r0 + rs, R);
  g.c0 = min(g.rank * cs, C);
  g.c1 = min(g.c0 + cs, C);
  return g;
}

// Dynamic shared memory of one CTA (the same layout for every kernel):
// the two-slot tile ring of the Sinkhorn loop (2 x TR rows), then psi
// (full copy), the column partials, the log column
// marginals of the CTA's merge slice, and the stripe's potentials,
// marginals and rounding state. pm/ps hold the column partials
// of the Sinkhorn loop and, as pv/pi, the partial column argmaxes of the
// rounding.
struct Smem {
  unsigned char *ring;  // tiles of the stored score type; the peel's cache
  float *psi, *pm, *ps, *log_c, *phi, *log_r, *skip_all;
  int *assign, *row_arg;
  uint8_t *flags, *row_ok, *col_ok, *col_taken, *wanted;
};

// elements of one ring slot holding `item`-byte scores: TR rows rounded up
// to 16 bytes, plus 16 bytes of slack for the tile's alignment shift
__host__ __device__ inline size_t slot_elems(int TR, int C, int item) {
  const size_t v = 16 / item;
  return (((size_t)TR * C + v - 1) & ~(v - 1)) + v;
}

// same layout as smem_bytes() in ops/cuda_sinkhorn.py, which checks the limit
static inline size_t smem_bytes(int R, int C, int G, int TR, int item) {
  const size_t rs = (size_t)((R + G - 1) / G), cs = (size_t)((C + G - 1) / G);
  return 2 * item * slot_elems(TR, C, item) + 15 * (size_t)C + 4 * cs + 4 * (size_t)R +
         18 * rs;
}

__device__ inline Smem carve(void *base, int R, int C, int G, int TR, int item) {
  const int rs = (R + G - 1) / G;
  Smem s;
  s.ring = (unsigned char *)base;
  s.psi = (float *)(s.ring + 2 * item * slot_elems(TR, C, item));
  s.pm = s.psi + C;
  s.ps = s.pm + C;
  s.log_c = s.ps + C;
  s.phi = s.log_c + (C + G - 1) / G;
  s.log_r = s.phi + rs;
  s.skip_all = s.log_r + rs;
  int *n = (int *)(s.skip_all + R);
  s.assign = n;
  s.row_arg = s.assign + rs;
  uint8_t *b = (uint8_t *)(s.row_arg + rs);
  s.flags = b;
  s.row_ok = s.flags + rs;
  s.col_ok = s.row_ok + rs;
  s.col_taken = s.col_ok + C;
  s.wanted = s.col_taken + C;
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4-byte asynchronous copy global -> shared (sm_80+)
__device__ __forceinline__ void cp_async4(float *smem, const float *gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// mbarrier and bulk (TMA) copy helpers (sm_90)
__device__ __forceinline__ void mbar_init(uint64_t *bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A ring slot (slot_elems) holds a tile plus 16 bytes of slack: tile t of
// the stripe starts at element (src mod 16 bytes) of its slot, so that
// source and destination share their alignment and the body moves as one
// bulk copy.
template <typename T>
__device__ __forceinline__ int tile_shift(const T *src) {
  return (int)(((uintptr_t)src / sizeof(T)) & (16 / sizeof(T) - 1));
}

// one unaligned head or tail element: cp.async for a float, a plain copy
// for a bf16 (cp.async moves 4, 8 or 16 bytes); both are visible after the
// barrier that follows the tile's mbarrier wait
__device__ __forceinline__ void copy_elem(float *dst, const float *src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16 *dst, const __nv_bfloat16 *src) {
  *dst = *src;
}

// Start copying tile t (rows [t*TR, t*TR + TR) of the stripe) into its
// slot: one thread of the second-to-last warp hands the 16-byte-aligned
// body to the bulk-copy engine (completion on the slot's mbarrier), and up
// to 14 lanes of warp 1 copy the unaligned head and tail elements. The
// last warp, which takes the leftover columns, does neither.
template <typename T>
__device__ __forceinline__ void fetch_tile(T *slot, uint64_t *bar, const T *Sr, int C,
                                           int nloc, int TR, int t) {
  constexpr int V = 16 / sizeof(T);  // elements per 16 bytes
  const int n = min(TR, nloc - t * TR) * C;
  const T *src = Sr + (size_t)t * TR * C;
  T *dst = slot + tile_shift(src);
  const int head = min((V - tile_shift(src)) & (V - 1), n);
  const int body = (n - head) / V * V;
  const int tail = n - head - body;
  const int tid = threadIdx.x;
  const int nbytes = (int)sizeof(T) * body;
  if (tid == TW_THREADS - 64) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(nbytes)
                 : "memory");
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
          "%2, [%3];\n" ::"r"(smem_addr(dst + head)),
          "l"(src + head), "r"(nbytes), "r"(smem_addr(bar))
          : "memory");
  } else if (tid >= 32 && tid < 32 + head) {
    copy_elem(dst + tid - 32, src + tid - 32);
  } else if (tid >= 40 && tid < 40 + tail) {
    const int e = n - tail + (tid - 40);
    copy_elem(dst + e, src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Log-domain Sinkhorn on phi = f/eps (this CTA's stripe), psi = g/eps
// (full copy) for one [R, C] block spread over the cluster. Fixed n_iters
// when tol_phi == 0, else stops after the first iteration whose largest
// live-row |delta phi| over the whole block is <= tol_phi (that update is
// kept). Returns the number of iterations run.
//
// The stripe streams through a two-slot ring of TR-row tiles in shared
// memory (a bulk copy per tile, the next tile in flight while this one is
// used), and each tile is read once per iteration: its rows' phi update
// (16/TR warps per row; the last warp of a row to finish merges the row's
// partials), then its contribution to the column partials with the new
// phi (a thread per column). The ring never stops: the tile after the
// last one is the next iteration's first. The log-sum-exps run on
// x = S / eps + pot in natural units (exponentials of x - max in base 2).
template <typename T>
__device__ int sinkhorn_cluster(cg::cluster_group cl,
                                const T *__restrict__ S, int R, int C,
                                const Geo &g, int TR, int n_iters, float inv_eps,
                                float tol_phi, const Smem &sm) {
  __shared__ float s_delta[2];
  __shared__ float s_dmax;
  __shared__ float s_rm[TW_WARPS], s_rs[TW_WARPS];
  __shared__ int s_done[TW_BATCH];
  __shared__ __align__(8) uint64_t s_bar[2];  // one per ring slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nloc = g.r1 - g.r0, ntiles = (nloc + TR - 1) / TR;
  const int wpr = TW_WARPS / TR;
  const int seg = max(32 * TW_BATCH, C / wpr / (32 * TW_BATCH) * (32 * TW_BATCH));
  const T *Sr = S + (size_t)g.r0 * C;
  T *ring = (T *)sm.ring;
  for (int i = tid; i < nloc; i += TW_THREADS) sm.phi[i] = 0.f;
  for (int j = tid; j < C; j += TW_THREADS) sm.psi[j] = 0.f;
  if (tid < TW_BATCH) s_done[tid] = 0;
  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
  }
  __syncthreads();
  if (tid == 0) {
    s_delta[0] = 0.f;
    s_delta[1] = 0.f;
  }
  const size_t slot = slot_elems(TR, C, sizeof(T));
  const bool streams = ntiles > 0 && n_iters > 0;
  if (streams) fetch_tile(ring, &s_bar[0], Sr, C, nloc, TR, 0);
  __syncthreads();
  int it = 0, k = 0;  // k counts tiles over all iterations (ring slot k & 1)
  while (it < n_iters) {
    // peers read s_delta[(it + 1) & 1] of the last iteration before the
    // last barrier, so it can be cleared now
    if (tid == 0) s_delta[(it + 1) & 1] = 0.f;
    for (int j = tid; j < C; j += TW_THREADS) {
      sm.pm[j] = -INFINITY;
      sm.ps[j] = 0.f;
    }
    for (int t = 0; t < ntiles; ++t, ++k) {
      const T *tile = ring + (k & 1) * slot + tile_shift(Sr + (size_t)t * TR * C);
      const int rows = min(TR, nloc - t * TR), l0 = t * TR;
      mbar_wait(&s_bar[k & 1], (k >> 1) & 1);
      cp_async_wait_all();
      __syncthreads();  // tile k landed; every thread is done with slot k+1
      fetch_tile(ring + ((k + 1) & 1) * slot, &s_bar[(k + 1) & 1], Sr, C, nloc, TR,
                 t + 1 < ntiles ? t + 1 : 0);
      // row partials: warp -> (tile row q, column segment); full batches
      // of 8 per lane, then the ragged end one element at a time
      const int q = warp / wpr;
      if (q < rows) {
        const int sgi = warp % wpr, jlo = min(C, sgi * seg);
        const int jhi = sgi == wpr - 1 ? C : min(C, jlo + seg);
        const T *row = tile + (size_t)q * C;
        // two independent accumulators for instruction-level parallelism
        float m = -INFINITY, s = 0.f, m2 = -INFINITY, s2 = 0.f;
        int j0 = jlo + lane;
        for (; j0 + 32 * (2 * TW_BATCH - 1) < jhi; j0 += 64 * TW_BATCH) {
          float x[TW_BATCH], y[TW_BATCH];
#pragma unroll
          for (int u = 0; u < TW_BATCH; ++u) {
            const int ja = j0 + 32 * u, jb = ja + 32 * TW_BATCH;
            x[u] = __fmaf_rn(to_f32(row[ja]), inv_eps, sm.psi[ja]);
            y[u] = __fmaf_rn(to_f32(row[jb]), inv_eps, sm.psi[jb]);
          }
          lse_batch(m, s, x);
          lse_batch(m2, s2, y);
        }
        if (j0 + 32 * (TW_BATCH - 1) < jhi) {
          float x[TW_BATCH];
#pragma unroll
          for (int u = 0; u < TW_BATCH; ++u)
            x[u] = __fmaf_rn(to_f32(row[j0 + 32 * u]), inv_eps, sm.psi[j0 + 32 * u]);
          lse_batch(m, s, x);
          j0 += 32 * TW_BATCH;
        }
        for (; j0 < jhi; j0 += 32)
          lse_push(m2, s2, __fmaf_rn(to_f32(row[j0]), inv_eps, sm.psi[j0]));
        lse_merge(m, s, m2, s2);
        group_lse(m, s, 32);
        int last = 0;
        if (lane == 0) {
          s_rm[warp] = m;
          s_rs[warp] = s;
          __threadfence_block();
          last = atomicAdd(&s_done[q], 1) == wpr - 1;
        }
        if (__shfl_sync(TW_FULL, last, 0)) {
          // the row's last warp merges the row's wpr partials (a lane each)
          __threadfence_block();
          float rm = -INFINITY, rs = 0.f;
          if (lane < wpr) {
            rm = s_rm[q * wpr + lane];
            rs = s_rs[q * wpr + lane];
          }
          group_lse(rm, rs, wpr);
          if (lane == 0) {
            s_done[q] = 0;
            const int li = l0 + q;
            const float lr = sm.log_r[li];
            const float f_new = lr > 0.5f * kNeg ? lr - lse_ln(rm, rs) : kNeg;
            const float d = fabsf(f_new - sm.phi[li]);
            if (lr > 0.5f * kNeg && d > 0.f)
              atomicMax((int *)&s_delta[it & 1], __float_as_int(d));
            sm.phi[li] = f_new;
          }
        }
      }
      __syncthreads();
      // column partials: this tile's rows with their new phi
      float ph[TW_BATCH];
#pragma unroll
      for (int u = 0; u < TW_BATCH; ++u) ph[u] = u < rows ? sm.phi[l0 + u] : 0.f;
      // two columns per pass (independent chains), both loads in range;
      // later passes run the threads in reverse, so that the leftover
      // columns (the skip column at C = 2^k + 1) fall to the last warp
      for (int j0 = 0; j0 < C; j0 += 2 * TW_THREADS) {
        const int j = j0 + (j0 == 0 ? tid : TW_THREADS - 1 - tid);
        if (j >= C) continue;
        const int jb = min(j + TW_THREADS, C - 1);
        float x[TW_BATCH], y[TW_BATCH];
#pragma unroll
        for (int u = 0; u < TW_BATCH; ++u) {
          const T *r = tile + (size_t)min(u, TR - 1) * C;
          x[u] = u < rows ? __fmaf_rn(to_f32(r[j]), inv_eps, ph[u]) : -INFINITY;
          y[u] = u < rows ? __fmaf_rn(to_f32(r[jb]), inv_eps, ph[u]) : -INFINITY;
        }
        float m = sm.pm[j], s = sm.ps[j], m2 = sm.pm[jb], s2 = sm.ps[jb];
        lse_batch(m, s, x);
        lse_batch(m2, s2, y);
        sm.pm[j] = m;
        sm.ps[j] = s;
        if (j + TW_THREADS < C) {
          sm.pm[jb] = m2;
          sm.ps[jb] = s2;
        }
      }
    }
    cl.sync();
    if (tid == 0) {
      float d = 0.f;
      for (int q = 0; q < g.G; ++q) d = fmaxf(d, *cl.map_shared_rank(&s_delta[it & 1], q));
      s_dmax = d;
    }
    // merge this CTA's column slice: a lane per (column, peer)
    const int n = (g.c1 - g.c0) * g.G;
    for (int base = 0; base < n; base += TW_THREADS) {
      const int e = base + tid, q = e % g.G, j = g.c0 + e / g.G;
      const bool ok = e < n;
      float m = -INFINITY, s = 0.f;
      if (ok) {
        m = *cl.map_shared_rank(sm.pm + j, q);
        s = *cl.map_shared_rank(sm.ps + j, q);
      }
      group_lse(m, s, g.G);
      if (ok) {
        const float lc = sm.log_c[j - g.c0];
        *cl.map_shared_rank(sm.psi + j, q) = lc > 0.5f * kNeg ? lc - lse_ln(m, s) : kNeg;
      }
    }
    cl.sync();
    ++it;
    if (tol_phi > 0.f && s_dmax <= tol_phi) break;
  }
  if (streams) mbar_wait(&s_bar[k & 1], (k >> 1) & 1);  // the tile past the last
  cp_async_wait_all();
  __syncthreads();
  return it;
}

// plan entry accessors for the rounding code (row i is a block row)
template <typename T>
struct PlanFromScores {
  const T *S;
  int C, r0;
  float inv_eps;
  const float *phi, *psi;  // phi of the stripe starting at row r0
  __device__ float operator()(int i, int j) const {
    return plan_val(to_f32(S[(size_t)i * C + j]), inv_eps, phi[i - r0], psi[j]);
  }
};

struct PlanFromTensor {
  const float *P;
  int C;
  __device__ float operator()(int i, int j) const {
    return P[(size_t)i * C + j];
  }
};

// Greedy mutual-best rounding (ops/rounding.py greedy_round_core) over
// rows [0, n_rows) and columns [0, C), skip column C - 1, then the top-k
// peel (topk_peel_core) of the col-valid plan, spread over the cluster:
// this CTA rounds the rows of its stripe below n_rows. sm.row_ok (stripe)
// and sm.col_ok must be set. The masked plan ("mass") is never stored: an
// entry is unavailable when its row is invalid or assigned, its column
// invalid or taken, or it is the skip column after the capacity ran out.
template <class Plan>
__device__ int round_and_peel(cg::cluster_group cl, const Plan &P,
                              int n_rows, int C, const Geo &g, int TR, int item, int cap,
                              int topk,
                              float min_mass, const Smem &sm, int *assign_out,
                              int *topk_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int skip_col = C - 1;
  const int lo = g.r0, nloc = max(min(g.r1, n_rows) - lo, 0);
  // s_cnt[parity] = {skip commits, any commit} of a round, read by peers
  __shared__ int s_cnt[2][2];
  __shared__ int s_skip_used, s_closed, s_progress;
  __shared__ int s_pk[TW_WARPS][TW_MAX_TOPK];
  float *pv = sm.pm;
  int *pi = (int *)sm.ps;

  for (int li = tid; li < nloc; li += TW_THREADS) sm.assign[li] = -1;
  for (int j = tid; j < C; j += TW_THREADS) {
    sm.col_taken[j] = 0;
    sm.wanted[j] = 0;
  }
  if (tid == 0) {
    s_cnt[0][0] = s_cnt[0][1] = s_cnt[1][0] = s_cnt[1][1] = 0;
    s_skip_used = 0;
    s_closed = 0;
  }
  cl.sync();  // every peer is initialised before the first remote store

  int rounds = 0;
  for (int t = 0; t < n_rows; ++t) {
    const int closed = s_closed;
    // 1. row pass: each unassigned valid row's best available column;
    //    its wanted column and skip mass go to every peer
    for (int li = warp; li < nloc; li += TW_WARPS) {
      const int i = lo + li;
      uint8_t fl = 0;
      float sk = -INFINITY;
      if (sm.row_ok[li] && sm.assign[li] == -1) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int j0 = lane; j0 < C; j0 += 32 * TW_BATCH) {
          float v[TW_BATCH];
#pragma unroll
          for (int u = 0; u < TW_BATCH; ++u) {
            const int j = j0 + 32 * u;
            const bool ok = j < C && sm.col_ok[j] && !sm.col_taken[j] &&
                            !(j == skip_col && closed);
            v[u] = ok ? P(i, j) : -INFINITY;
          }
#pragma unroll
          for (int u = 0; u < TW_BATCH; ++u)
            if (v[u] > bv) {
              bv = v[u];
              bi = j0 + 32 * u;
            }
        }
        warp_argmax(bv, bi);
        if (bv > 0.5f * kNeg) {
          fl = F_ACTIVE;
          float smass = (sm.col_ok[skip_col] && !closed) ? P(i, skip_col) : kNeg;
          if (smass > 0.5f * kNeg) {
            fl |= F_CONTENDER;
            sk = smass;
          }
          if (bi == skip_col)
            fl |= F_WANTS_SKIP;
          else if (lane < g.G)
            *cl.map_shared_rank(sm.wanted + bi, lane) = 1;
          if (lane == 0) sm.row_arg[li] = bi;
        }
      }
      if (lane < g.G) *cl.map_shared_rank(sm.skip_all + i, lane) = sk;
      if (lane == 0) sm.flags[li] = fl;
    }
    cl.sync();
    // peers read s_cnt[(t + 1) & 1] before this round's first barrier
    if (tid == 0) s_cnt[(t + 1) & 1][0] = s_cnt[(t + 1) & 1][1] = 0;
    // 2. column pass: this stripe's best unassigned row of every wanted
    //    real column
    for (int j = tid; j < skip_col; j += TW_THREADS) {
      if (!sm.wanted[j]) continue;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int l0 = 0; l0 < nloc; l0 += TW_BATCH) {
        float v[TW_BATCH];
#pragma unroll
        for (int u = 0; u < TW_BATCH; ++u) {
          const int li = l0 + u;
          const bool ok = li < nloc && sm.row_ok[li] && sm.assign[li] == -1;
          v[u] = ok ? P(lo + li, j) : -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < TW_BATCH; ++u)
          if (v[u] > bv) {
            bv = v[u];
            bi = lo + l0 + u;
          }
      }
      pv[j] = bv;
      pi[j] = bi;
    }
    cl.sync();
    // 3. commits: mutual-best real pairs (a row merges its column's G
    //    partials), and skip rows whose skip mass ranks inside the
    //    remaining capacity among all contenders of the block
    const int room = max(cap - s_skip_used, 0);
    for (int li = warp; li < nloc; li += TW_WARPS) {
      const int i = lo + li;
      const uint8_t fl = sm.flags[li];
      if (fl & F_WANTS_SKIP) {
        const float mi = sm.skip_all[i];
        int rank = 0;
        for (int k = lane; k < n_rows; k += 32) {
          const float mk = sm.skip_all[k];
          rank += (mk > mi || (mk == mi && k < i));
        }
        for (int off = 16; off > 0; off >>= 1)
          rank += __shfl_xor_sync(TW_FULL, rank, off);
        if (lane == 0 && rank < room) {
          sm.assign[li] = skip_col;
          atomicAdd(&s_cnt[t & 1][0], 1);
          s_cnt[t & 1][1] = 1;
        }
      } else if (fl & F_ACTIVE) {
        const int j = sm.row_arg[li];
        float bv = -INFINITY;
        int bi = INT_MAX;
        if (lane < g.G) {
          bv = *cl.map_shared_rank(pv + j, lane);
          bi = *cl.map_shared_rank(pi + j, lane);
        }
        warp_argmax(bv, bi);
        if (bi == i) {
          if (lane < g.G) *cl.map_shared_rank(sm.col_taken + j, lane) = 1;
          if (lane == 0) {
            sm.assign[li] = j;
            s_cnt[t & 1][1] = 1;
          }
        }
      }
    }
    for (int j = tid; j < C; j += TW_THREADS) sm.wanted[j] = 0;
    cl.sync();
    if (tid == 0) {
      int nskip = 0, any = 0;
      for (int q = 0; q < g.G; ++q) {
        const int *c = cl.map_shared_rank(&s_cnt[t & 1][0], q);
        nskip += c[0];
        any |= c[1];
      }
      s_skip_used += nskip;
      if (s_skip_used >= cap) s_closed = 1;
      s_progress = any;
    }
    __syncthreads();
    ++rounds;
    if (!s_progress) break;
  }

  for (int li = tid; li < nloc; li += TW_THREADS) assign_out[lo + li] = sm.assign[li];

  // top-k peel over the col-valid plan (rows are not masked): k passes
  // of argmax + mask; a pass whose best unpicked value is -inf takes the
  // first unpicked index. The first pass keeps the row's masked plan in
  // a row of the (now idle) tile ring, so the later passes read shared
  // memory; a warp per row, as many warps as the ring has f32 rows
  // (2 x TR x item / 4, item the stored score's bytes).
  int *pk = s_pk[warp];
  const int n_peel = min(TW_WARPS, 2 * TR * item / 4);
  float *cache = (float *)sm.ring + (size_t)warp * C;
  for (int li = warp; li < nloc && warp < n_peel; li += n_peel) {
    const int i = lo + li;
    for (int step = 0; step < topk; ++step) {
      float bv = -INFINITY;
      int bi = INT_MAX, first_free = INT_MAX;
      for (int j0 = lane; j0 < C; j0 += 32 * TW_BATCH) {
        float v[TW_BATCH];
#pragma unroll
        for (int u = 0; u < TW_BATCH; ++u) {
          const int j = j0 + 32 * u;
          bool ok = j < C;
          if (step == 0) {
            if (ok) cache[j] = v[u] = sm.col_ok[j] ? P(i, j) : kNeg;
          } else {
            for (int q = 0; q < step; ++q) ok &= (pk[q] != j);
            if (ok) v[u] = cache[j];
          }
          if (ok && j < first_free) first_free = j;
          if (!ok) v[u] = -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < TW_BATCH; ++u)
          if (v[u] > bv) {
            bv = v[u];
            bi = j0 + 32 * u;
          }
      }
      __syncwarp();
      warp_argmax(bv, bi);
      for (int off = 16; off > 0; off >>= 1)
        first_free = min(first_free, __shfl_xor_sync(TW_FULL, first_free, off));
      if (bv == -INFINITY) {
        bi = first_free;
        bv = cache[bi];
      }
      if (lane == 0) {
        pk[step] = bi;
        topk_out[(size_t)i * topk + step] = bv > min_mass ? bi : -1;
      }
      __syncwarp();
    }
  }
  cl.sync();  // peers may still read this CTA's counters
  return rounds;
}

// load the stripe's log row marginals and every column's log marginal
__device__ inline void load_marginals(const float *row_marg, const float *col_marg,
                                      int C, const Geo &g, const Smem &sm) {
  const int tid = threadIdx.x;
  for (int li = tid; li < g.r1 - g.r0; li += TW_THREADS)
    sm.log_r[li] = log_marginal(row_marg[g.r0 + li]);
  for (int j = tid; j < C; j += TW_THREADS) {
    if (j >= g.c0 && j < g.c1) sm.log_c[j - g.c0] = log_marginal(col_marg[j]);
    sm.col_ok[j] = col_marg[j] > 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(TW_THREADS, 1)
fused_assign_kernel(const T *__restrict__ S, const float *__restrict__ row_marg,
                    const float *__restrict__ col_marg, const float *__restrict__ cap,
                    int R, int C, int TR, int n_rows, int n_iters, float inv_eps,
                    float tol_phi, int topk, float min_mass, int *assign_out,
                    int *topk_out, int *stats_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Geo g = geometry(cl, R, C);
  const int b = blockIdx.x / g.G;
  Smem sm = carve(tw_smem, R, C, g.G, TR, sizeof(T));
  const T *Sb = S + (size_t)b * R * C;
  load_marginals(row_marg + (size_t)b * R, col_marg + (size_t)b * C, C, g, sm);
  for (int li = threadIdx.x; li < g.r1 - g.r0; li += TW_THREADS)
    sm.row_ok[li] = sm.log_r[li] > 0.5f * kNeg;
  __syncthreads();
  const int iters = sinkhorn_cluster(cl, Sb, R, C, g, TR, n_iters, inv_eps, tol_phi, sm);
  PlanFromScores<T> P{Sb, C, g.r0, inv_eps, sm.phi, sm.psi};
  const int rounds = round_and_peel(cl, P, n_rows, C, g, TR, sizeof(T), (int)cap[b], topk,
                                    min_mass, sm, assign_out + (size_t)b * n_rows,
                                    topk_out + (size_t)b * n_rows * topk);
  if (threadIdx.x == 0 && g.rank == 0) {
    stats_out[2 * b] = iters;
    stats_out[2 * b + 1] = rounds;
  }
}

template <typename T>
__global__ void __launch_bounds__(TW_THREADS, 1)
sinkhorn_plan_kernel(const T *__restrict__ S, const float *__restrict__ row_marg,
                     const float *__restrict__ col_marg, int R, int C, int TR,
                     int n_iters, float inv_eps, float tol_phi, float *plan_out,
                     int *iters_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Geo g = geometry(cl, R, C);
  const int b = blockIdx.x / g.G;
  Smem sm = carve(tw_smem, R, C, g.G, TR, sizeof(T));
  const T *Sb = S + (size_t)b * R * C;
  load_marginals(row_marg + (size_t)b * R, col_marg + (size_t)b * C, C, g, sm);
  __syncthreads();
  const int iters = sinkhorn_cluster(cl, Sb, R, C, g, TR, n_iters, inv_eps, tol_phi, sm);
  // the stripe's plan rows; no peer reads this CTA's memory after the
  // loop's last barrier
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int li = warp; li < g.r1 - g.r0; li += TW_WARPS) {
    const size_t off = (size_t)b * R * C + (size_t)(g.r0 + li) * C;
    for (int j = lane; j < C; j += 32)
      plan_out[off + j] = plan_val(to_f32(S[off + j]), inv_eps, sm.phi[li], sm.psi[j]);
  }
  if (threadIdx.x == 0 && g.rank == 0) iters_out[b] = iters;
}

__global__ void __launch_bounds__(TW_THREADS, 1)
round_topk_kernel(const float *__restrict__ plan, const uint8_t *__restrict__ row_valid,
                  const uint8_t *__restrict__ col_valid, const float *__restrict__ cap,
                  int N, int C, int TR, int topk, float min_mass, int *assign_out,
                  int *topk_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Geo g = geometry(cl, N, C);
  const int b = blockIdx.x / g.G, tid = threadIdx.x;
  Smem sm = carve(tw_smem, N, C, g.G, TR, sizeof(float));
  for (int li = tid; li < g.r1 - g.r0; li += TW_THREADS)
    sm.row_ok[li] = row_valid[(size_t)b * N + g.r0 + li] != 0;
  for (int j = tid; j < C; j += TW_THREADS) sm.col_ok[j] = col_valid[(size_t)b * C + j] != 0;
  __syncthreads();
  PlanFromTensor P{plan + (size_t)b * N * C, C};
  round_and_peel(cl, P, N, C, g, TR, sizeof(float), (int)cap[b], topk, min_mass, sm,
                 assign_out + (size_t)b * N, topk_out + (size_t)b * N * topk);
}

// Allow G-CTA clusters (16 is above the portable 8) and the block's
// dynamic shared memory.
template <class K>
static cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

static cudaLaunchConfig_t cluster_config(int B, int G, size_t smem, void *stream,
                                         cudaLaunchAttribute *attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * G), 1, 1);
  cfg.blockDim = dim3(TW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
static int max_active_clusters(int G, int R, int C, int TR, int *out) {
  const size_t smem = smem_bytes(R, C, G, TR, sizeof(T));
  cudaError_t err = prepare(fused_assign_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, G, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, fused_assign_kernel<T>, &cfg);
}

template <typename T>
static int launch_fused_assign(const void *S, const float *row_marg, const float *col_marg,
                               const float *cap, int B, int R, int C, int n_rows,
                               int n_iters, float inv_eps, float tol_phi, int topk,
                               float min_mass, int *assign_out, int *topk_out,
                               int *stats_out, int G, int TR, void *stream) {
  const size_t smem = smem_bytes(R, C, G, TR, sizeof(T));
  cudaError_t err = prepare(fused_assign_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, G, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_assign_kernel<T>, (const T *)S, row_marg, col_marg,
                           cap, R, C, TR, n_rows, n_iters, inv_eps, tol_phi, topk,
                           min_mass, assign_out, topk_out, stats_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_sinkhorn(const void *S, const float *row_marg, const float *col_marg,
                           int B, int R, int C, int n_iters, float inv_eps, float tol_phi,
                           float *plan_out, int *iters_out, int G, int TR, void *stream) {
  const size_t smem = smem_bytes(R, C, G, TR, sizeof(T));
  cudaError_t err = prepare(sinkhorn_plan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, G, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, sinkhorn_plan_kernel<T>, (const T *)S, row_marg,
                           col_marg, R, C, TR, n_iters, inv_eps, tol_phi, plan_out,
                           iters_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

// How many G-CTA clusters of the kernels (the same threads and shared
// memory for all three) the card runs at once at `item`-byte scores; 0
// when none fits.
int tw_max_active_clusters(int G, int R, int C, int TR, int item, int *out) {
  return item == 2 ? max_active_clusters<__nv_bfloat16>(G, R, C, TR, out)
                   : max_active_clusters<float>(G, R, C, TR, out);
}

// S holds f32 scores (item 4) or bf16 ones (item 2)
int tw_fused_assign(const void *S, const float *row_marg, const float *col_marg,
                    const float *cap, int B, int R, int C, int n_rows, int n_iters,
                    float inv_eps, float tol_phi, int topk, float min_mass,
                    int *assign_out, int *topk_out, int *stats_out, int G, int TR,
                    int item, void *stream) {
  return (item == 2 ? launch_fused_assign<__nv_bfloat16> : launch_fused_assign<float>)(
      S, row_marg, col_marg, cap, B, R, C, n_rows, n_iters, inv_eps, tol_phi, topk,
      min_mass, assign_out, topk_out, stats_out, G, TR, stream);
}

int tw_sinkhorn(const void *S, const float *row_marg, const float *col_marg, int B,
                int R, int C, int n_iters, float inv_eps, float tol_phi,
                float *plan_out, int *iters_out, int G, int TR, int item, void *stream) {
  return (item == 2 ? launch_sinkhorn<__nv_bfloat16> : launch_sinkhorn<float>)(
      S, row_marg, col_marg, B, R, C, n_iters, inv_eps, tol_phi, plan_out, iters_out, G,
      TR, stream);
}

int tw_round_topk(const float *plan, const uint8_t *row_valid, const uint8_t *col_valid,
                  const float *cap, int B, int N, int C, int topk, float min_mass,
                  int *assign_out, int *topk_out, int G, int TR, void *stream) {
  const size_t smem = smem_bytes(N, C, G, TR, sizeof(float));
  cudaError_t err = prepare(round_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, G, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, round_topk_kernel, plan, row_valid, col_valid, cap, N,
                           C, TR, topk, min_mass, assign_out, topk_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
