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
// What bounds it on this card: the work is one [R, C] f32 score block per
// window (R = W + 1 rows with the dummy row, C = M + 1 columns with the
// skip column; 8.4 MB at 1025 x 2049). A lower bound reads it once; the
// Sinkhorn loop does an exp and a few adds per element and half-iteration,
// so at the main-path size the f32 operations, not the bytes, set the
// bound. The block does not fit in shared memory (227 KB), so this design
// keeps only the potentials (phi [R], psi [C]) and the rounding state
// (assignments, taken columns, per-row argmax) in shared memory and
// re-reads the score block from L2/HBM on every half-iteration and every
// rounding round, recomputing plan entries exp(clip(S/eps + phi + psi))
// on the fly instead of storing the plan.
//
// What the design does about it: one CTA of 1024 threads per window block
// (grid = B windows), so all synchronisation is __syncthreads and the
// data-dependent exits (Sinkhorn tolerance, "no commit this round") are
// plain loop breaks. Row log-sum-exps use a warp per row (lanes stride
// the columns, online max/sum in one pass); column log-sum-exps use a
// thread per column looping over rows (coalesced). This uses B of the
// 132 SMs and re-reads the block ~2 x iterations times, so it is far
// from its bound; clusters with distributed shared memory, multi-CTA
// column reductions and a persistent grid are the later work.
//
// Plan entries are formed with __fmul_rn/__fadd_rn (never contracted into
// an FMA), so the fused kernel's on-the-fly plan equals the plan the
// plain Sinkhorn kernel writes, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#define TW_THREADS 1024
#define TW_WARPS (TW_THREADS / 32)
#define TW_MAX_TOPK 16
#define TW_FULL 0xffffffffu

static const float kNeg = -1.0e9f;

// row flags of one rounding round
#define F_ACTIVE 1
#define F_WANTS_SKIP 2
#define F_CONTENDER 4

__device__ __forceinline__ float log_marginal(float m) {
  return m > 0.f ? logf(fmaxf(m, 1e-30f)) : kNeg;
}

__device__ __forceinline__ float logit(float s, float inv_eps, float pot) {
  return __fadd_rn(__fmul_rn(s, inv_eps), pot);
}

__device__ __forceinline__ float plan_val(float s, float inv_eps, float phi,
                                          float psi) {
  float x = __fadd_rn(__fadd_rn(__fmul_rn(s, inv_eps), phi), psi);
  return expf(fminf(fmaxf(x, -80.f), 80.f));
}

// online log-sum-exp accumulator (m = running max, s = sum of exp(x - m))
__device__ __forceinline__ void lse_push(float &m, float &s, float x) {
  if (x > m) {
    s = __fmaf_rn(s, expf(m - x), 1.f);
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float &m, float &s, float m2,
                                          float s2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2;
    s = s2;
    return;
  }
  if (m2 > m) {
    s = __fmaf_rn(s, expf(m - m2), s2);
    m = m2;
  } else {
    s = __fmaf_rn(s2, expf(m2 - m), s);
  }
}

__device__ __forceinline__ void warp_lse(float &m, float &s) {
  for (int off = 16; off > 0; off >>= 1) {
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

// Dynamic shared memory of one CTA (the same layout for every kernel).
struct Smem {
  float *phi, *psi, *log_r, *log_c, *skip_m;
  int *assign, *row_arg, *col_best;
  uint8_t *flags, *row_ok, *col_ok, *col_taken, *wanted;
};

// same layout as smem_bytes() in ops/cuda_sinkhorn.py, which checks the limit
static inline size_t smem_bytes(int R, int C) {
  return (size_t)4 * (5 * (size_t)R + 3 * (size_t)C) + 2 * (size_t)R +
         3 * (size_t)C;
}

__device__ inline Smem carve(void *base, int R, int C) {
  Smem s;
  float *f = (float *)base;
  s.phi = f;
  s.psi = s.phi + R;
  s.log_r = s.psi + C;
  s.log_c = s.log_r + R;
  s.skip_m = s.log_c + C;
  int *n = (int *)(s.skip_m + R);
  s.assign = n;
  s.row_arg = s.assign + R;
  s.col_best = s.row_arg + R;
  uint8_t *b = (uint8_t *)(s.col_best + C);
  s.flags = b;
  s.row_ok = s.flags + R;
  s.col_ok = s.row_ok + R;
  s.col_taken = s.col_ok + C;
  s.wanted = s.col_taken + C;
  return s;
}

// Log-domain Sinkhorn on phi = f/eps, psi = g/eps for one [R, C] block.
// Fixed n_iters when tol_phi == 0, else stops after the first iteration
// whose largest live-row |delta phi| is <= tol_phi (that update is kept).
// Returns the number of iterations run.
__device__ int sinkhorn_block(const float *__restrict__ S, int R, int C,
                              int n_iters, float inv_eps, float tol_phi,
                              const Smem &sm, float *delta /* [2] */) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < R; i += TW_THREADS) sm.phi[i] = 0.f;
  for (int j = tid; j < C; j += TW_THREADS) sm.psi[j] = 0.f;
  if (tid == 0) {
    delta[0] = 0.f;
    delta[1] = 0.f;
  }
  __syncthreads();
  int it = 0;
  while (it < n_iters) {
    float *d = delta + (it & 1);
    // row update: warp per row
    float wdelta = 0.f;
    for (int i = warp; i < R; i += TW_WARPS) {
      const float *row = S + (size_t)i * C;
      float m = -INFINITY, s = 0.f;
      for (int j = lane; j < C; j += 32)
        lse_push(m, s, logit(row[j], inv_eps, sm.psi[j]));
      warp_lse(m, s);
      if (lane == 0) {
        float lr = sm.log_r[i];
        float f_new = lr > 0.5f * kNeg ? lr - (m + logf(s)) : kNeg;
        if (lr > 0.5f * kNeg) wdelta = fmaxf(wdelta, fabsf(f_new - sm.phi[i]));
        sm.phi[i] = f_new;
      }
    }
    if (lane == 0 && wdelta > 0.f)
      atomicMax((int *)d, __float_as_int(wdelta));
    __syncthreads();
    if (tid == 0) delta[(it + 1) & 1] = 0.f;
    // column update: thread per column
    for (int j = tid; j < C; j += TW_THREADS) {
      float m = -INFINITY, s = 0.f;
      for (int i = 0; i < R; ++i)
        lse_push(m, s, logit(S[(size_t)i * C + j], inv_eps, sm.phi[i]));
      float lc = sm.log_c[j];
      sm.psi[j] = lc > 0.5f * kNeg ? lc - (m + logf(s)) : kNeg;
    }
    __syncthreads();
    ++it;
    if (tol_phi > 0.f && *d <= tol_phi) break;
  }
  return it;
}

// plan entry accessors for the rounding code
struct PlanFromScores {
  const float *S;
  int C;
  float inv_eps;
  const float *phi, *psi;
  __device__ float operator()(int i, int j) const {
    return plan_val(S[(size_t)i * C + j], inv_eps, phi[i], psi[j]);
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
// peel (topk_peel_core) of the col-valid plan. sm.row_ok / sm.col_ok must
// be set. The masked plan ("mass") is never stored: an entry is
// unavailable when its row is invalid or assigned, its column invalid or
// taken, or it is the skip column after the capacity ran out.
template <class Plan>
__device__ int round_and_peel(const Plan &P, int n_rows, int C, int cap,
                              int topk, float min_mass, const Smem &sm,
                              int *assign_out, int *topk_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int skip_col = C - 1;
  __shared__ int s_skip_used, s_skip_closed, s_nskip, s_any, s_progress;
  __shared__ int s_pk[TW_WARPS][TW_MAX_TOPK];

  for (int i = tid; i < n_rows; i += TW_THREADS) sm.assign[i] = -1;
  for (int j = tid; j < C; j += TW_THREADS) {
    sm.col_taken[j] = 0;
    sm.wanted[j] = 0;
  }
  if (tid == 0) {
    s_skip_used = 0;
    s_skip_closed = 0;
    s_nskip = 0;
    s_any = 0;
  }
  __syncthreads();

  int rounds = 0;
  for (int t = 0; t < n_rows; ++t) {
    const int closed = s_skip_closed;
    // 1. row pass: each unassigned valid row's best available column
    for (int i = warp; i < n_rows; i += TW_WARPS) {
      uint8_t fl = 0;
      if (sm.row_ok[i] && sm.assign[i] == -1) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int j = lane; j < C; j += 32) {
          if (!sm.col_ok[j] || sm.col_taken[j] || (j == skip_col && closed))
            continue;
          float v = P(i, j);
          if (v > bv) {
            bv = v;
            bi = j;
          }
        }
        warp_argmax(bv, bi);
        if (bv > 0.5f * kNeg) {
          fl = F_ACTIVE;
          float smass = (sm.col_ok[skip_col] && !closed) ? P(i, skip_col) : kNeg;
          if (smass > 0.5f * kNeg) fl |= F_CONTENDER;
          if (bi == skip_col)
            fl |= F_WANTS_SKIP;
          else if (lane == 0)
            sm.wanted[bi] = 1;
          if (lane == 0) {
            sm.row_arg[i] = bi;
            sm.skip_m[i] = smass;
          }
        }
      }
      if (lane == 0) sm.flags[i] = fl;
    }
    __syncthreads();
    // 2. column pass: best unassigned row of every wanted real column
    for (int j = tid; j < skip_col; j += TW_THREADS) {
      if (!sm.wanted[j]) continue;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int i = 0; i < n_rows; ++i) {
        if (!sm.row_ok[i] || sm.assign[i] != -1) continue;
        float v = P(i, j);
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
      sm.col_best[j] = bi;
    }
    __syncthreads();
    // 3. commits: mutual-best real pairs, and skip rows whose skip mass
    //    ranks inside the remaining capacity among all contenders
    const int room = max(cap - s_skip_used, 0);
    for (int i = tid; i < n_rows; i += TW_THREADS) {
      const uint8_t fl = sm.flags[i];
      if (fl & F_WANTS_SKIP) {
        const float mi = sm.skip_m[i];
        int rank = 0;
        for (int k = 0; k < n_rows; ++k) {
          if (!(sm.flags[k] & F_CONTENDER)) continue;
          const float mk = sm.skip_m[k];
          rank += (mk > mi || (mk == mi && k < i));
        }
        if (rank < room) {
          sm.assign[i] = skip_col;
          atomicAdd(&s_nskip, 1);
          s_any = 1;
        }
      } else if (fl & F_ACTIVE) {
        const int j = sm.row_arg[i];
        if (sm.col_best[j] == i) {
          sm.assign[i] = j;
          sm.col_taken[j] = 1;
          s_any = 1;
        }
      }
    }
    for (int j = tid; j < C; j += TW_THREADS) sm.wanted[j] = 0;
    __syncthreads();
    if (tid == 0) {
      s_skip_used += s_nskip;
      s_nskip = 0;
      if (s_skip_used >= cap) s_skip_closed = 1;
      s_progress = s_any;
      s_any = 0;
    }
    __syncthreads();
    ++rounds;
    if (!s_progress) break;
  }

  for (int i = tid; i < n_rows; i += TW_THREADS) assign_out[i] = sm.assign[i];

  // top-k peel over the col-valid plan (rows are not masked): k passes
  // of argmax + mask; a pass whose best unpicked value is -inf takes the
  // first unpicked index
  int *pk = s_pk[warp];
  for (int i = warp; i < n_rows; i += TW_WARPS) {
    for (int step = 0; step < topk; ++step) {
      float bv = -INFINITY;
      int bi = INT_MAX, first_free = INT_MAX;
      for (int j = lane; j < C; j += 32) {
        bool picked = false;
        for (int q = 0; q < step; ++q) picked |= (pk[q] == j);
        if (picked) continue;
        if (j < first_free) first_free = j;
        float v = sm.col_ok[j] ? P(i, j) : kNeg;
        if (v > bv) {
          bv = v;
          bi = j;
        }
      }
      warp_argmax(bv, bi);
      for (int off = 16; off > 0; off >>= 1)
        first_free = min(first_free, __shfl_xor_sync(TW_FULL, first_free, off));
      if (bv == -INFINITY) {
        bi = first_free;
        bv = sm.col_ok[bi] ? P(i, bi) : kNeg;
      }
      if (lane == 0) {
        pk[step] = bi;
        topk_out[(size_t)i * topk + step] = bv > min_mass ? bi : -1;
      }
      __syncwarp();
    }
  }
  return rounds;
}

__global__ void __launch_bounds__(TW_THREADS, 1)
fused_assign_kernel(const float *__restrict__ S, const float *__restrict__ row_marg,
                    const float *__restrict__ col_marg, const float *__restrict__ cap,
                    int R, int C, int n_rows, int n_iters, float inv_eps,
                    float tol_phi, int topk, float min_mass, int *assign_out,
                    int *topk_out, int *stats_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  __shared__ float s_delta[2];
  const int b = blockIdx.x, tid = threadIdx.x;
  Smem sm = carve(tw_smem, R, C);
  const float *Sb = S + (size_t)b * R * C;
  for (int i = tid; i < R; i += TW_THREADS) {
    sm.log_r[i] = log_marginal(row_marg[(size_t)b * R + i]);
    if (i < n_rows) sm.row_ok[i] = sm.log_r[i] > 0.5f * kNeg;
  }
  for (int j = tid; j < C; j += TW_THREADS) {
    sm.log_c[j] = log_marginal(col_marg[(size_t)b * C + j]);
    sm.col_ok[j] = sm.log_c[j] > 0.5f * kNeg;
  }
  __syncthreads();
  const int iters = sinkhorn_block(Sb, R, C, n_iters, inv_eps, tol_phi, sm, s_delta);
  PlanFromScores P{Sb, C, inv_eps, sm.phi, sm.psi};
  const int rounds = round_and_peel(P, n_rows, C, (int)cap[b], topk, min_mass, sm,
                                    assign_out + (size_t)b * n_rows,
                                    topk_out + (size_t)b * n_rows * topk);
  if (tid == 0) {
    stats_out[2 * b] = iters;
    stats_out[2 * b + 1] = rounds;
  }
}

__global__ void __launch_bounds__(TW_THREADS, 1)
sinkhorn_plan_kernel(const float *__restrict__ S, const float *__restrict__ row_marg,
                     const float *__restrict__ col_marg, int R, int C, int n_iters,
                     float inv_eps, float tol_phi, float *plan_out, int *iters_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  __shared__ float s_delta[2];
  const int b = blockIdx.x, tid = threadIdx.x;
  Smem sm = carve(tw_smem, R, C);
  const float *Sb = S + (size_t)b * R * C;
  for (int i = tid; i < R; i += TW_THREADS)
    sm.log_r[i] = log_marginal(row_marg[(size_t)b * R + i]);
  for (int j = tid; j < C; j += TW_THREADS)
    sm.log_c[j] = log_marginal(col_marg[(size_t)b * C + j]);
  __syncthreads();
  const int iters = sinkhorn_block(Sb, R, C, n_iters, inv_eps, tol_phi, sm, s_delta);
  float *Pb = plan_out + (size_t)b * R * C;
  const size_t n = (size_t)R * C;
  for (size_t e = tid; e < n; e += TW_THREADS) {
    const int i = (int)(e / C), j = (int)(e % C);
    Pb[e] = plan_val(Sb[e], inv_eps, sm.phi[i], sm.psi[j]);
  }
  if (tid == 0) iters_out[b] = iters;
}

__global__ void __launch_bounds__(TW_THREADS, 1)
round_topk_kernel(const float *__restrict__ plan, const uint8_t *__restrict__ row_valid,
                  const uint8_t *__restrict__ col_valid, const float *__restrict__ cap,
                  int N, int C, int topk, float min_mass, int *assign_out,
                  int *topk_out) {
  extern __shared__ __align__(16) unsigned char tw_smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  Smem sm = carve(tw_smem, N, C);
  for (int i = tid; i < N; i += TW_THREADS) sm.row_ok[i] = row_valid[(size_t)b * N + i] != 0;
  for (int j = tid; j < C; j += TW_THREADS) sm.col_ok[j] = col_valid[(size_t)b * C + j] != 0;
  __syncthreads();
  PlanFromTensor P{plan + (size_t)b * N * C, C};
  round_and_peel(P, N, C, (int)cap[b], topk, min_mass, sm, assign_out + (size_t)b * N,
                 topk_out + (size_t)b * N * topk);
}

template <class K>
static int prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)err;
}

extern "C" {

int tw_fused_assign(const float *S, const float *row_marg, const float *col_marg,
                    const float *cap, int B, int R, int C, int n_rows, int n_iters,
                    float inv_eps, float tol_phi, int topk, float min_mass,
                    int *assign_out, int *topk_out, int *stats_out, void *stream) {
  size_t smem = smem_bytes(R, C);
  int err = prepare(fused_assign_kernel, smem);
  if (err) return err;
  fused_assign_kernel<<<B, TW_THREADS, smem, (cudaStream_t)stream>>>(
      S, row_marg, col_marg, cap, R, C, n_rows, n_iters, inv_eps, tol_phi, topk,
      min_mass, assign_out, topk_out, stats_out);
  return (int)cudaGetLastError();
}

int tw_sinkhorn(const float *S, const float *row_marg, const float *col_marg, int B,
                int R, int C, int n_iters, float inv_eps, float tol_phi,
                float *plan_out, int *iters_out, void *stream) {
  size_t smem = smem_bytes(R, C);
  int err = prepare(sinkhorn_plan_kernel, smem);
  if (err) return err;
  sinkhorn_plan_kernel<<<B, TW_THREADS, smem, (cudaStream_t)stream>>>(
      S, row_marg, col_marg, R, C, n_iters, inv_eps, tol_phi, plan_out, iters_out);
  return (int)cudaGetLastError();
}

int tw_round_topk(const float *plan, const uint8_t *row_valid, const uint8_t *col_valid,
                  const float *cap, int B, int N, int C, int topk, float min_mass,
                  int *assign_out, int *topk_out, void *stream) {
  size_t smem = smem_bytes(N, C);
  int err = prepare(round_topk_kernel, smem);
  if (err) return err;
  round_topk_kernel<<<B, TW_THREADS, smem, (cudaStream_t)stream>>>(
      plan, row_valid, col_valid, cap, N, C, topk, min_mass, assign_out, topk_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
