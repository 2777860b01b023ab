// Hopper (sm_90a) kernel for the solver's block assembly.
//
// assemble_block_kernel<T> builds one endpoint's whole OT block of a batch
// of windows in one pass, T = float or __nv_bfloat16 (the score type):
//
//   S[b, i, j]   = feas(b, i, j) ? ((root + (pred_1 + ...)) + (succ_1 + ...)) + ret
//                                : NEG
//   term_q       = active_q[b] && row_ok_q[b, i] ? lse_k(log w_k + comp_k) : 0
//   comp_k       = fma(-z/2, z, -log sd_k) - log(2 pi)/2,  z = (x - mu_k) / sd_k
//   x            = col[b, j] - row_t[b, i], or row_t[b, i] - col[b, j] (flip),
//                  col = o_s or o_e
//   feas(b,i,j)  = in_v[i] && o_v[j] && in_s[i] <= o_s[j] && o_e[j] <= in_e[i]
//                  && t_prev[i] <= o_s[j] && !force_skip[i]
//                  && (forward sweep || o_e[j] <= t_succ[i])
//   skip[b, i]   = !in_v[i] ? NEG : force_skip[i] ? 0
//                  : max(max_j S[b, i, j] - SKIP_MARGIN, SKIP_FLOOR)
//   S_ot         = [[S, skip], [0 ... 0]]               [B, W+1, M+1] of T
//
// At bf16 each row is centred at its best score max_j S[b, i, j] (0 where
// that is masked), entries at or below NEG/2 are kept at NEG, and each
// entry is rounded once to nearest even. Beside S_ot it writes each row's
// feasible count and the first index of its largest entry in the stored
// type (the solver's not-best flag).
//
// It replaces the score build and block assembly of the solver's endpoint
// step (traceweaver_tpu/algorithms/weaver_tpu.py:224-311, which XLA fuses
// on the TPU and which is no Pallas kernel there; in the port before this
// kernel a score-build kernel wrote the raw block and some fifteen plain
// PyTorch passes over [B, W, M] masked it, added the skip column, centred
// and rounded it and added the dummy row, with four blocks alive at once).
//
// What bounds it on this card: writing S_ot once (4 or 2 bytes a pair at
// 3.35 TB/s), then the mixture arithmetic (an IEEE quotient, K exponentials
// and one logarithm per feasible pair and active term). Most pairs of a
// window are infeasible, so the design evaluates the mixture only where
// the block keeps it:
//
// - A warp owns a row. The CTA stages its window's column arrays (o_s, o_e,
//   o_v) and each term's live mixture components (mu, sd, -log sd, log w)
//   in shared memory once, every load of a stage issued before its stores;
//   row times, masks and term activity are warp-uniform, so a masked term
//   or row is a uniform branch.
// - Pass 1 tests feasibility 128 columns an iteration (4 a lane, each a
//   ballot over 32 consecutive columns, which is also the row's bit mask)
//   and compacts the feasible columns into a shared list (its length is
//   the feasible count).
// - Pass 2 evaluates the active terms on the compacted list only, every
//   lane busy, the component loop unrolled for each live count (a template
//   parameter, chosen once per term by a uniform switch), the groups summed
//   in the plain build's order. Warp shuffles give the row's best score,
//   hence its skip score and bf16 centre, and the argmax of what the row
//   stores: every masked entry stores NEG, so its candidates are the
//   feasible entries, the first masked column and the skip column.
// - Pass 3 writes the row in its final type with 16-byte vector stores
//   (the row buffer is offset so that its vectors line up with the
//   unaligned rows of the [.., M+1] block), NEG where the mask says so.
//
// The arithmetic is the plain version's: fmaf rounds -z/2 * z - log sd once
// (the FMA that XLA contracts), the quotient is IEEE (__fdiv_rn), expf and
// logf are the ones PyTorch's CUDA kernels call, and the terms add as the
// plain build adds them.
//
// A launch's term descriptors ride in the kernel's parameters up to
// TWA_MAX_TERMS; a longer list is read from a device array of descriptors,
// still in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define TWA_MAX_K 8
#define TWA_MAX_TERMS 32
#define TWA_WARPS 4          // warps a CTA at most
#define TWA_ROWS_PER_WARP 4  // rows a warp, so a CTA stages its window once for them
#define TWA_FULL 0xffffffffu

// A diagnostic build (-DTWA_PHASE_CLOCKS) sums each warp's clock cycles by
// phase of the kernel into twa_phase_clocks: 0 staging the window, 1 a row's
// loads and active terms, 2 pass 1, 3 pass 2, 4 the row's reductions and
// argmax, 5 pass 3 and the dummy row. The default build has none of it.
#ifdef TWA_PHASE_CLOCKS
#define TWA_PHASES 6
__device__ unsigned long long twa_phase_clocks[TWA_PHASES];
#define TWA_CLOCK(t) const long long t = clock64()
#define TWA_ADD(phase, t0, t1) \
  if (lane == 0) atomicAdd(&twa_phase_clocks[phase], (unsigned long long)((t1) - (t0)))
#else
#define TWA_CLOCK(t)
#define TWA_ADD(phase, t0, t1)
#endif

static const float kHalfLog2Pi = 0.9189385332046727f;
static const float kNeg = -1.0e9f;
static const float kNegHalf = -5.0e8f;
static const float kSkipMargin = 4.0f;
static const float kSkipFloor = -60.0f;

// One term: [B, W] row times, [B, K] mixture, [B] active, optional [B, W]
// row mask, each with its batch stride (the last dimension is contiguous);
// which column array it reads, its orientation and its group (0 root, 1
// predecessor, 2 successor, 3 return; the list is in group order).
struct TwaTerm {
  const float *row_t, *wt, *mu, *sd;
  const uint8_t *active, *row_ok;
  long long s_row, s_par, s_act, s_ok;
  int col, flip, group, pad;
};

// The block's operands: outputs S_ot [B, W+1, M+1] (contiguous, T),
// feas_count and argmax [B, W] (contiguous int32); row operands [B, W] and
// column operands [B, M] with their batch strides; t_succ null on a
// forward sweep.
struct TwaBlock {
  void *S_ot;
  int *feas_count, *argmax;
  const float *in_s, *in_e, *t_prev, *t_succ, *o_s, *o_e;
  const uint8_t *in_v, *force_skip, *o_v;
  long long s_in_s, s_in_e, s_in_v, s_t_prev, s_t_succ, s_fs, s_os, s_oe, s_ov;
  int B, W, M, K, n_terms, bf16;
};

struct TwaArgs {
  TwaBlock k;
  int warps, rows_per_cta, chunks, pad;
  const TwaTerm *ext;  // device descriptors when n_terms > TWA_MAX_TERMS
  TwaTerm t[TWA_MAX_TERMS];
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Column arrays are padded to a multiple of 128 (4 columns a lane of a
// warp): the padding is invalid, so pass 1 needs no bound check.
__host__ __device__ inline int padded_cols(int M) { return (M + 127) & ~127; }

// Shared memory: the CTA's part (columns, mixtures, each term's live
// components and meta, its row pointers), then each warp's (the row's
// scores, feasibility bits, active terms and their row times, feasible
// columns).
__host__ __device__ inline size_t cta_bytes(int M, int n) {
  const size_t Mp = padded_cols(M);
  return 9 * Mp + align16(4 * (size_t)n * TWA_MAX_K) * 4 + align16(4 * (size_t)n) * 2
       + align16(8 * (size_t)n) * 2;
}
__host__ __device__ inline size_t warp_bytes(int M, int n) {
  return align16(4 * ((size_t)M + 1 + 8)) + padded_cols(M) / 8
       + align16(4 * (size_t)n) * 2 + align16(2 * (size_t)M);
}

template <int k>
__device__ __forceinline__ float mixture_lse(float x, const float *mu, const float *sd,
                                             const float *nls, const float *lw) {
  float v[k];
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < k; ++u) {
    const float z = __fdiv_rn(x - mu[u], sd[u]);
    v[u] = (__fmaf_rn(-0.5f * z, z, nls[u]) - kHalfLog2Pi) + lw[u];
    m = fmaxf(m, v[u]);
  }
  if (m == -INFINITY) return -INFINITY;  // every component underflows: log 0
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < k; ++u) s += expf(v[u] - m);
  return logf(s) + m;
}

// k live components (uniform over the warp); none: log 0.
__device__ __forceinline__ float term_lse(int k, float x, const float *mu, const float *sd,
                                          const float *nls, const float *lw) {
  switch (k) {
    case 1: return mixture_lse<1>(x, mu, sd, nls, lw);
    case 2: return mixture_lse<2>(x, mu, sd, nls, lw);
    case 3: return mixture_lse<3>(x, mu, sd, nls, lw);
    case 4: return mixture_lse<4>(x, mu, sd, nls, lw);
    case 5: return mixture_lse<5>(x, mu, sd, nls, lw);
    case 6: return mixture_lse<6>(x, mu, sd, nls, lw);
    case 7: return mixture_lse<7>(x, mu, sd, nls, lw);
    case 8: return mixture_lse<8>(x, mu, sd, nls, lw);
    default: return -INFINITY;
  }
}

template <typename T> struct Store;
template <> struct Store<float> {
  static constexpr int kVec = 4;  // elements per 16-byte store
  __device__ static float round(float v, float) { return v; }
  __device__ static float value(float v) { return v; }
  __device__ static void put(float *p, float v) { *p = v; }
  __device__ static void put_vec(float *p, const float *v) {
    *reinterpret_cast<float4 *>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Store<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // centred at ref; entries at or below NEG/2 stay NEG; one rounding
  __device__ static __nv_bfloat16 round(float v, float ref) {
    return __float2bfloat16_rn(v <= kNegHalf ? kNeg : v - ref);
  }
  __device__ static float value(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static void put(__nv_bfloat16 *p, __nv_bfloat16 v) { *p = v; }
  __device__ static void put_vec(__nv_bfloat16 *p, const __nv_bfloat16 *v) {
    uint4 u;
    memcpy(&u, v, 16);
    *reinterpret_cast<uint4 *>(p) = u;
  }
};

// torch.argmax's order: a NaN is largest, ties go to the first index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// Entries [0, M] of a row in its final type: entry j < M is rb[j] where
// column j is feasible (bit j of mask) and NEG where not; entry M is the
// skip score rb[M]. rb starts (off % kVec) elements into a 16-byte slot, so
// rb + j is vector-aligned exactly where out + j is.
template <typename T>
__device__ void store_row(T *out, size_t off, const float *rb, const unsigned *mask,
                          bool row_on, int M, float ref, int lane) {
  constexpr int V = Store<T>::kVec;
  const int n = M + 1;
  const int head = min((int)((V - off % V) % V), n);
  auto entry = [&](int j, float x) {
    const bool keep = j >= M || (row_on && ((mask[j >> 5] >> (j & 31)) & 1u));
    return Store<T>::round(keep ? x : kNeg, ref);
  };
  if (lane < head) Store<T>::put(out + lane, entry(lane, rb[lane]));
  const int nv = (n - head) / V;
  for (int v = lane; v < nv; v += 32) {
    const int j0 = head + v * V;
    float x[V];
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      const float4 f = *reinterpret_cast<const float4 *>(rb + j0 + u);
      x[u] = f.x;
      x[u + 1] = f.y;
      x[u + 2] = f.z;
      x[u + 3] = f.w;
    }
    T r[V];
#pragma unroll
    for (int u = 0; u < V; ++u) r[u] = entry(j0 + u, x[u]);
    Store<T>::put_vec(out + j0, r);
  }
  const int j = head + nv * V + lane;
  if (j < n) Store<T>::put(out + j, entry(j, rb[j]));
}

template <typename T>
__device__ void zero_row(T *out, size_t off, int n, int lane) {
  constexpr int V = Store<T>::kVec;
  const int head = min((int)((V - off % V) % V), n);
  if (lane < head) out[lane] = T(0.f);
  const int nv = (n - head) / V;
  for (int v = lane; v < nv; v += 32)
    *reinterpret_cast<uint4 *>(out + head + v * V) = make_uint4(0u, 0u, 0u, 0u);
  const int j = head + nv * V + lane;
  if (j < n) out[j] = T(0.f);
}

template <typename T>
__global__ void __launch_bounds__(TWA_WARPS * 32)
assemble_block_kernel(const __grid_constant__ TwaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TwaBlock &k = a.k;
  const int M = k.M, W = k.W, n = k.n_terms, Mp = padded_cols(M);
  const TwaTerm *terms = a.ext ? a.ext : a.t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  TWA_CLOCK(c_start);

  unsigned char *p = smem;
  float *s_os = reinterpret_cast<float *>(p); p += 4 * (size_t)Mp;
  float *s_oe = reinterpret_cast<float *>(p); p += 4 * (size_t)Mp;
  uint8_t *s_ov = p;                          p += Mp;
  const size_t par = align16(4 * (size_t)n * TWA_MAX_K);
  float *s_mu = reinterpret_cast<float *>(p);  p += par;
  float *s_sd = reinterpret_cast<float *>(p);  p += par;
  float *s_nls = reinterpret_cast<float *>(p); p += par;
  float *s_lw = reinterpret_cast<float *>(p);  p += par;
  int *s_k = reinterpret_cast<int *>(p);       p += align16(4 * (size_t)n);
  int *s_meta = reinterpret_cast<int *>(p);    p += align16(4 * (size_t)n);
  const float **s_rowp = reinterpret_cast<const float **>(p);  p += align16(8 * (size_t)n);
  const uint8_t **s_okp = reinterpret_cast<const uint8_t **>(p); p += align16(8 * (size_t)n);
  p += warp * warp_bytes(M, n);
  float *buf = reinterpret_cast<float *>(p);   p += align16(4 * ((size_t)M + 1 + 8));
  unsigned *mask = reinterpret_cast<unsigned *>(p); p += Mp / 8;
  float *w_r = reinterpret_cast<float *>(p);   p += align16(4 * (size_t)n);
  int *w_q = reinterpret_cast<int *>(p);       p += align16(4 * (size_t)n);
  uint16_t *idx = reinterpret_cast<uint16_t *>(p);

  const int b = blockIdx.x / a.chunks;
  const int r0 = (blockIdx.x - b * a.chunks) * a.rows_per_cta;
  const int r1 = min(r0 + a.rows_per_cta, W + 1);
  const size_t bb = (size_t)b;

  // --- the window's columns and mixtures, once per CTA ------------------
  // (every load of a stage issued before its stores)
  for (int j0 = threadIdx.x; j0 < Mp; j0 += 4 * blockDim.x) {
    float os[4], oe[4];
    uint8_t ov[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      const bool in = j < M;
      os[u] = in ? k.o_s[bb * k.s_os + j] : 0.f;
      oe[u] = in ? k.o_e[bb * k.s_oe + j] : 0.f;
      ov[u] = in ? k.o_v[bb * k.s_ov + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < Mp) {
        s_os[j] = os[u];
        s_oe[j] = oe[u];
        s_ov[j] = ov[u];
      }
    }
  }
  for (int e = threadIdx.x; e < n * TWA_MAX_K; e += blockDim.x) {
    const int q = e / TWA_MAX_K, c = e % TWA_MAX_K;
    const TwaTerm &t = terms[q];
    float w = 0.f, mu = 0.f, sd = 1.f;
    if (c < k.K) {
      const size_t o = bb * t.s_par + c;
      w = t.wt[o];
      mu = t.mu[o];
      sd = t.sd[o];
    }
    s_mu[e] = mu;
    s_sd[e] = sd;
    s_lw[e] = w;  // the weight until the compaction below
    if (c == 0) {
      s_k[q] = t.active[bb * t.s_act] ? 0 : -1;  // -1: the term is off here
      s_meta[q] = t.col | (t.flip << 1) | (t.group << 2);
      s_rowp[q] = t.row_t + bb * t.s_row;
      s_okp[q] = t.row_ok ? t.row_ok + bb * t.s_ok : nullptr;
    }
  }
  __syncthreads();
  // each term's live components first, with -log sd and log w; zero-weight
  // components add nothing
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    if (s_k[q] < 0) continue;
    int live = 0;
    for (int c = 0; c < k.K; ++c) {
      const int e = q * TWA_MAX_K + c, d = q * TWA_MAX_K + live;
      const float w = s_lw[e];
      if (w > 0.f) {
        const float sd = s_sd[e];
        s_mu[d] = s_mu[e];
        s_sd[d] = sd;
        s_nls[d] = -logf(sd);
        s_lw[d] = logf(fmaxf(w, 1e-30f));
        ++live;
      }
    }
    s_k[q] = live;
  }
  __syncthreads();
  TWA_CLOCK(c_staged);
  TWA_ADD(0, c_start, c_staged);

  T *S_ot = reinterpret_cast<T *>(k.S_ot);
  for (int i = r0 + warp; i < r1; i += a.warps) {
    const size_t off = (bb * (W + 1) + i) * (size_t)(M + 1);
    TWA_CLOCK(c_row);
    if (i == W) {  // the dummy row
      zero_row<T>(S_ot + off, off, M + 1, lane);
      TWA_CLOCK(c_zero);
      TWA_ADD(5, c_row, c_zero);
      continue;
    }
    const bool iv = k.in_v[bb * k.s_in_v + i] != 0;
    const bool fs = k.force_skip[bb * k.s_fs + i] != 0;
    const float is = k.in_s[bb * k.s_in_s + i], ie = k.in_e[bb * k.s_in_e + i];
    const float tp = k.t_prev[bb * k.s_t_prev + i];
    const bool bwd = k.t_succ != nullptr;
    const float ts = bwd ? k.t_succ[bb * k.s_t_succ + i] : 0.f;
    const bool row_on = iv && !fs;

    // the row's active terms in list order, and where each group ends
    int nact = 0, end0 = 0, end1 = 0, end2 = 0;
    for (int q0 = 0; q0 < n; q0 += 32) {
      const int q = q0 + lane;
      bool on = false;
      float r = 0.f;
      if (q < n && s_k[q] >= 0) {
        const uint8_t *ok = s_okp[q];
        r = s_rowp[q][i];
        on = !ok || ok[i];
      }
      const unsigned bal = __ballot_sync(TWA_FULL, on);
      const int g = q < n ? (s_meta[q] >> 2) : 3;
      end0 += __popc(__ballot_sync(TWA_FULL, on && g < 1));
      end1 += __popc(__ballot_sync(TWA_FULL, on && g < 2));
      end2 += __popc(__ballot_sync(TWA_FULL, on && g < 3));
      if (on) {
        const int at = nact + __popc(bal & lt);
        w_q[at] = q;
        w_r[at] = r;
      }
      nact += __popc(bal);
    }

    TWA_CLOCK(c_terms);
    TWA_ADD(1, c_row, c_terms);

    // pass 1: feasibility, 128 columns an iteration, compacted; bit j of
    // mask is column j's
    int cnt = 0;
    if (row_on) {
      for (int j0 = 0; j0 < Mp; j0 += 128) {
        bool f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + 32 * u + lane;
          const float os = s_os[j], oe = s_oe[j];
          f[u] = s_ov[j] && is <= os && oe <= ie && tp <= os && (!bwd || oe <= ts);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned bal = __ballot_sync(TWA_FULL, f[u]);
          if (f[u]) idx[cnt + __popc(bal & lt)] = (uint16_t)(j0 + 32 * u + lane);
          cnt += __popc(bal);
          if (lane == 0) mask[(j0 >> 5) + u] = bal;
        }
      }
    }
    __syncwarp();
    TWA_CLOCK(c_pass1);
    TWA_ADD(2, c_terms, c_pass1);

    // pass 2: the mixture terms on the feasible pairs
    float *rb = buf + off % Store<T>::kVec;
    float vmax = -INFINITY;
    bool nan = false;
    for (int c = lane; c < cnt; c += 32) {
      const int j = idx[c];
      const float cs = s_os[j], ce = s_oe[j];
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      const int ends[4] = {end0, end1, end2, nact};
      int at = 0;
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        for (; at < ends[grp]; ++at) {
          const int q = w_q[at];
          const int meta = s_meta[q];
          const float col = (meta & 1) ? ce : cs;
          const float x = (meta & 2) ? w_r[at] - col : col - w_r[at];
          const int o = q * TWA_MAX_K;
          g[grp] += term_lse(s_k[q], x, s_mu + o, s_sd + o, s_nls + o, s_lw + o);
        }
      }
      const float v = ((g[0] + g[1]) + g[2]) + g[3];
      rb[j] = v;
      vmax = fmaxf(vmax, v);
      nan |= v != v;
    }

    TWA_CLOCK(c_pass2);
    TWA_ADD(3, c_pass1, c_pass2);

    // the row's best score and skip column
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(TWA_FULL, vmax, s));
    float best = cnt < M ? fmaxf(vmax, kNeg) : vmax;
    if (__any_sync(TWA_FULL, nan)) best = NAN;
    float skip = best - kSkipMargin;
    if (!(skip != skip)) skip = fmaxf(skip, kSkipFloor);
    if (fs) skip = 0.f;
    if (!iv) skip = kNeg;
    if (lane == 0) rb[M] = skip;
    const float ref = best > kNegHalf ? best : 0.f;
    __syncwarp();

    // the argmax of what the row stores: its feasible entries, its first
    // masked column (every masked entry stores NEG) and its skip column
    float bv = -INFINITY;
    int bj = M + 1;
    for (int c = lane; c < cnt; c += 32) {
      const int j = idx[c];
      const float s = Store<T>::value(Store<T>::round(rb[j], ref));
      if (better(s, j, bv, bj)) { bv = s; bj = j; }
    }
    int masked = row_on ? M : 0;  // the first masked column (M: none)
    if (row_on) {
      for (int w = lane; 32 * w < M; w += 32) {
        const int valid = min(32, M - 32 * w);
        const unsigned zeros = ~mask[w] & (valid == 32 ? TWA_FULL : (1u << valid) - 1u);
        if (zeros) masked = min(masked, 32 * w + __ffs(zeros) - 1);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      masked = min(masked, __shfl_xor_sync(TWA_FULL, masked, s));
      const float ov = __shfl_xor_sync(TWA_FULL, bv, s);
      const int oj = __shfl_xor_sync(TWA_FULL, bj, s);
      if (better(ov, oj, bv, bj)) { bv = ov; bj = oj; }
    }
    if (lane == 0) {
      if (masked < M) {
        const float s = Store<T>::value(Store<T>::round(kNeg, ref));
        if (better(s, masked, bv, bj)) { bv = s; bj = masked; }
      }
      const float s = Store<T>::value(Store<T>::round(skip, ref));
      if (better(s, M, bv, bj)) bj = M;
      k.feas_count[bb * W + i] = cnt;
      k.argmax[bb * W + i] = bj;
    }

    TWA_CLOCK(c_reduced);
    TWA_ADD(4, c_pass2, c_reduced);

    // pass 3: the row in its final type
    store_row<T>(S_ot + off, off, rb, mask, row_on, M, ref, lane);
    __syncwarp();  // the row's buffers are the next row's
    TWA_CLOCK(c_stored);
    TWA_ADD(5, c_reduced, c_stored);
  }
}

// The limit is set to the card's largest, the same from every thread, so
// that launches from several host threads at once never race on it.
template <typename T>
static int launch(const TwaArgs &a, size_t smem, int optin, unsigned grid,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(assemble_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         optin);
  if (err != cudaSuccess) return (int)err;
  assemble_block_kernel<T><<<grid, a.warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// One launch over the block `blk` with `blk->n_terms` descriptors: `terms`
// (host, used when there are at most TWA_MAX_TERMS) or `ext` (device, for a
// longer list). Returns the CUDA error of the launch (0 when it was
// accepted), or -1 when one warp's row does not fit in shared memory.
int tw_assemble_block(const TwaBlock *blk, const TwaTerm *terms, const TwaTerm *ext,
                      void *stream) {
  const int n = blk->n_terms;
  if (n < 1 || blk->K < 1 || blk->K > TWA_MAX_K || blk->M < 1 || blk->M > 65535
      || blk->W < 1 || (n > TWA_MAX_TERMS && !ext))
    return (int)cudaErrorInvalidValue;
  if (blk->B == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t fixed = cta_bytes(blk->M, n), per = warp_bytes(blk->M, n);
  int warps = TWA_WARPS;
  while (warps > 0 && fixed + warps * per > (size_t)optin) --warps;
  if (warps == 0) return -1;
  TwaArgs a;
  memset(&a, 0, sizeof(a));
  a.k = *blk;
  a.warps = warps;
  a.rows_per_cta = warps * TWA_ROWS_PER_WARP;
  a.chunks = (blk->W + 1 + a.rows_per_cta - 1) / a.rows_per_cta;
  if (n > TWA_MAX_TERMS) a.ext = ext;
  else memcpy(a.t, terms, sizeof(TwaTerm) * (size_t)n);
  const unsigned long long grid = (unsigned long long)blk->B * a.chunks;
  if (grid > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + warps * per;
  cudaStream_t st = (cudaStream_t)stream;
  return blk->bf16 ? launch<__nv_bfloat16>(a, smem, optin, (unsigned)grid, st)
                   : launch<float>(a, smem, optin, (unsigned)grid, st);
}

// sizeof(TwaBlock), sizeof(TwaTerm) and TWA_MAX_TERMS, for the binding's
// layout check.
int tw_assemble_block_size(void) { return (int)sizeof(TwaBlock); }
int tw_assemble_term_size(void) { return (int)sizeof(TwaTerm); }
int tw_assemble_max_terms(void) { return TWA_MAX_TERMS; }

#ifdef TWA_PHASE_CLOCKS
// The diagnostic build's cycles by phase (TWA_PHASES of them) into `out`,
// then zeroed. Returns the CUDA error.
int tw_assemble_phase_clocks(unsigned long long *out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, twa_phase_clocks, sizeof(twa_phase_clocks));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[TWA_PHASES] = {0};
  return (int)cudaMemcpyToSymbol(twa_phase_clocks, zero, sizeof(zero));
}
#endif

}  // extern "C"
