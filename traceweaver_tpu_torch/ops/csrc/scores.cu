// Hopper (sm_90a) kernel for the solver's score build.
//
// score_block_kernel builds one endpoint's f32 score block of a batch of
// windows from all its mixture terms in one pass: each term adds one
// edge's Gaussian-mixture delay log-density under its mask,
//
//   term_q[b, i, j] = active_q[b] && row_ok_q[b, i] ? lse_k(log w_k + comp_k) : 0
//   comp_k = fma(-z/2, z, -log sd_k) - log(2 pi)/2,  z = (x - mu_k) / sd_k
//   x = col_t[b, j] - row_t[b, i], or row_t[b, i] - col_t[b, j] (flip)
//
// and the block is written once, summed in the solver's grouping:
//
//   S = ((root + (pred_1 + pred_2 + ...)) + (succ_1 + ...)) + ret
//
// It replaces the score-build expressions of the solver's endpoint step
// (traceweaver_tpu/algorithms/weaver_tpu.py:224-255; ops/scores.py
// mixture_logpdf and pair_scores), which XLA fuses on the TPU and which are
// no Pallas kernel there. In plain PyTorch the same build promotes every
// mixture term to f64 over a [B, N, M, K] tensor (about 40 bytes a pair
// per temporary) to reproduce the FMA that XLA contracts; those
// temporaries set the solver's peak memory. Here one thread owns a pair,
// the four group sums and the K <= 8 components stay in registers, and
// fmaf rounds the product once, as the contracted FMA does.
//
// What bounds it on this card: one write of the f32 block (4 bytes a pair
// at 3.35 TB/s) against K exponentials and one logarithm a pair for every
// active term on the special-function units; with a dozen terms the
// special functions bind. The mixture rows of a window are read once per
// block into shared memory, with their -log sd and log w, and zero-weight
// components and masked terms are dropped there. A block covers a stretch
// of one window's pairs, consecutive threads on consecutive columns, so
// the block's stores coalesce and its row reads broadcast.
//
// A launch takes at most TWS_MAX_TERMS terms (the descriptors ride in the
// kernel's parameters); the wrapper splits a longer list into launches
// that accumulate into S.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define TWS_THREADS 256
#define TWS_MAX_K 8
#define TWS_MAX_TERMS 32
// pairs per thread before the grid wraps over a window
#define TWS_PER_THREAD 4

static const float kHalfLog2Pi = 0.9189385332046727f;

// One term: [B, N] row times, [B, M] column times, [B, K] mixture, [B]
// active, optional [B, N] row mask; each with its batch stride (the last
// dimension is contiguous). group: 0 root, 1 predecessor, 2 successor,
// 3 return.
struct TwsTerm {
  const float *row_t, *col_t, *wt, *mu, *sd;
  const uint8_t *active, *row_ok;
  long long s_row, s_col, s_par, s_act, s_ok;
  int flip, group;
};

struct TwsTerms {
  TwsTerm t[TWS_MAX_TERMS];
  int n, K, accumulate;
};

__global__ void __launch_bounds__(TWS_THREADS)
score_block_kernel(float *__restrict__ S, const __grid_constant__ TwsTerms terms,
                   int B, int N, int M) {
  __shared__ float s_mu[TWS_MAX_TERMS][TWS_MAX_K], s_sd[TWS_MAX_TERMS][TWS_MAX_K];
  __shared__ float s_nls[TWS_MAX_TERMS][TWS_MAX_K], s_lw[TWS_MAX_TERMS][TWS_MAX_K];
  __shared__ int s_k[TWS_MAX_TERMS];  // live components; -1: masked window
  const size_t pairs = (size_t)N * M;
  const int n = terms.n, K = terms.K;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the last window's parameters are no longer read
    if (threadIdx.x < n) {
      const int q = threadIdx.x;
      const TwsTerm &t = terms.t[q];
      int k = -1;
      if (t.active[(size_t)b * t.s_act]) {
        k = 0;
        const size_t o = (size_t)b * t.s_par;
        for (int c = 0; c < K; ++c) {
          const float w = t.wt[o + c];
          if (w > 0.f) {
            s_mu[q][k] = t.mu[o + c];
            s_sd[q][k] = t.sd[o + c];
            s_nls[q][k] = -logf(s_sd[q][k]);
            s_lw[q][k] = logf(fmaxf(w, 1e-30f));
            ++k;
          }
        }
      }
      s_k[q] = k;
    }
    __syncthreads();
    float *Sb = S + (size_t)b * pairs;
    for (size_t e = (size_t)blockIdx.x * TWS_THREADS + threadIdx.x; e < pairs;
         e += (size_t)gridDim.x * TWS_THREADS) {
      const int i = (int)(e / M), j = (int)(e - (size_t)i * M);
      float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
#pragma unroll 1
      for (int q = 0; q < n; ++q) {
        const int k = s_k[q];
        if (k < 0) continue;  // uniform over the block
        const TwsTerm &t = terms.t[q];
        if (t.row_ok && !t.row_ok[(size_t)b * t.s_ok + i]) continue;
        const float r = t.row_t[(size_t)b * t.s_row + i];
        const float c = t.col_t[(size_t)b * t.s_col + j];
        const float x = t.flip ? r - c : c - r;
        float v[TWS_MAX_K];
        float m = -INFINITY;
#pragma unroll
        for (int u = 0; u < TWS_MAX_K; ++u) {
          if (u < k) {
            const float z = __fdiv_rn(x - s_mu[q][u], s_sd[q][u]);
            v[u] = (__fmaf_rn(-0.5f * z, z, s_nls[q][u]) - kHalfLog2Pi) + s_lw[q][u];
            m = fmaxf(m, v[u]);
          }
        }
        float add;
        if (m == -INFINITY) {
          add = -INFINITY;  // no component (or every one underflows): log 0
        } else {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < TWS_MAX_K; ++u)
            if (u < k) s += expf(v[u] - m);
          add = logf(s) + m;
        }
        switch (t.group) {
          case 0: g0 += add; break;
          case 1: g1 += add; break;
          case 2: g2 += add; break;
          default: g3 += add; break;
        }
      }
      const float v = ((g0 + g1) + g2) + g3;
      Sb[e] = terms.accumulate ? Sb[e] + v : v;
    }
  }
}

extern "C" {

// One launch over B windows of [N, M] pairs on `stream` with `n` terms
// (at most TWS_MAX_TERMS, each of K <= TWS_MAX_K components); with
// `accumulate` the block is added into S, else S is overwritten. Returns
// the CUDA error of the launch (0 when it was accepted).
int tw_score_block(float *S, const TwsTerm *terms, int n, int K, int accumulate,
                   int B, int N, int M, void *stream) {
  if (n < 1 || n > TWS_MAX_TERMS || K > TWS_MAX_K) return (int)cudaErrorInvalidValue;
  const size_t pairs = (size_t)N * M;
  if (B == 0 || pairs == 0) return 0;
  TwsTerms p;
  memset(&p, 0, sizeof(p));
  memcpy(p.t, terms, sizeof(TwsTerm) * (size_t)n);
  p.n = n;
  p.K = K;
  p.accumulate = accumulate;
  const size_t per_block = (size_t)TWS_THREADS * TWS_PER_THREAD;
  const unsigned gx = (unsigned)((pairs + per_block - 1) / per_block);
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  score_block_kernel<<<dim3(gx, gy, 1), TWS_THREADS, 0, (cudaStream_t)stream>>>(
      S, p, B, N, M);
  return (int)cudaGetLastError();
}

// sizeof(TwsTerm) and TWS_MAX_TERMS, for the binding's layout check.
int tw_score_term_size(void) { return (int)sizeof(TwsTerm); }
int tw_score_max_terms(void) { return TWS_MAX_TERMS; }

}  // extern "C"
