// K1: the de novo assembly sampler for Hopper (sm_90a).
//
// Replaces mchap_tpu/ops/pallas_denovo.py::pallas_denovo_sampler (kernel
// body _make_full_kernel).  It computes the same Markov chain per chain:
// mutation sweep (systematic h-major site order, haplotype-copy proposal
// correction, A == 2 fast path) -> gate_r, gate_d -> Bernoulli breaks for
// j = 1..NB-1 -> per segment a recombination MH then a dosage MH on the
// permuted interval sums -> gate_f -> full-length dosage MH; rh rebuilt
// every `refresh` steps; base-next_pow2(A) packed trace.  The plain
// PyTorch version is mchap_tpu_torch/ops/cuda_denovo.py::
// denovo_sampler_plain, which consumes uniform draws in the same order.
//
// A second entry, mutation_sweep_launch, is K0: it replaces
// mchap_tpu/ops/pallas_denovo.py::pallas_mutation_sweep (body _make_kernel)
// with one call of the same mutation-sweep device code at an inverse
// temperature, starting from a given llk (plain version:
// cuda_denovo.py::mutation_sweep_plain).  K1 runs that code at temp = 1.
//
// What bounds it on this card: each chain is a long sequence of dependent
// MH decisions, and every decision waits on a sum over reads (R = 64 at
// typical depth) of logaddexp terms.  The work is latency of those
// dependent reductions and of expf/logf, not bandwidth: the per-problem
// log-read tensor lr[S, NB, A, R] is shared by all chains of a problem and
// is read from L2/L1, never replicated per chain.
//
// Layout: one warp per chain rung, lanes striding over reads.  Every sum
// over reads is a 5-step xor-butterfly of warp shuffles, so all lanes hold
// the bitwise-identical total (IEEE addition commutes) and take the same
// MH decision without a block barrier or a broadcast.  A rung's state
// lives in a slot of shared memory: genotype g[P][NB] (int8), rh[P][R] and
// the interval sums rhi[P][R] (f32), each read owned by one lane.  Several
// chain-warps per block and many blocks per SM hide the reduction latency.
// The structural sweeps accumulate every option's per-read candidate term
// in registers in one pass over reads (ploidy is a template parameter, so
// option tables unroll), then reduce them together.  Uniform draws come
// from Philox4x32-10, key (seed, chain), counter (step, draw index), or
// from a pinned noise[n_steps][D][C] tensor in tests.
//
// Tempering (the JAX kernel's n_temps > 1): a chain's T rungs are T
// consecutive warps of one block, rung t drawing from indices t * Dr ..
// and scaling every MH log ratio by temps[t].  After each step the rungs
// meet at a named barrier of their own (bar.sync 1 + chain, 32 * T), one
// lane runs the warm-to-cold neighbour swaps, exchanging the rungs' slot
// indices, llks and priors (a pointer swap: rh and g stay where they
// are), and a second barrier hands each rung its new slot.  Only the
// cold rung writes the trace.  Barriers are per chain, so a chain past C
// still leaves early without stalling another chain.  The ladder and the
// prior run in their own instance (denovo_ladder_kernel, 8-warp blocks
// for T = 8); the flat single-rung chain keeps an instance without them
// (denovo_kernel), whose registers and stack they would otherwise cost.
// The source is built twice, at once: by default into the library of
// denovo_kernel and K0, and with -DK1_LADDER into that of
// denovo_ladder_kernel; both export denovo_sampler_launch.
//
// Dirichlet-multinomial prior (the JAX kernel's use_prior): with per-
// problem dispersions alpha, the mutation ratio gains log(count_cur) -
// log(count_a) + log(count_a - 1 + alpha) - log(count_cur - 1 + alpha),
// and each structural option prior_S(new) - prior_S(cur), prior_S summing
// t(d) = sum_{k<d} log(alpha + k) - log d! (a table per chain) over the
// distinct rows of dosage d, read from the pairwise full-row equality
// masks that the structural step already forms.  Both sit inside the
// temperature factor, in the JAX kernel's f32 operation order.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxTemps = 8;

struct Params {
  const float* lr;       // [S][NB][A][R]
  const float* counts;   // [S][R]
  const int* nall;       // [S][NB]
  const float* pbreak;   // [S]
  const float* alpha;    // [S] DM dispersion, or null for the flat prior
  const int* problem;    // [C]
  const int* g_init;     // [P][NB][C]
  const float* noise;    // [n_steps][D][C] or null
  void* trace;           // [n_steps][NB][C], out_bytes each
  float* llks;           // [n_steps][C]
  int S, R, NB, A, C, n_steps;
  float p_recomb, p_partial, p_full;
  int refresh, stage, out_bytes;
  uint64_t seed;
  int warps;             // rung-warps per block: whole chains of T warps
  int T;                 // rungs per chain
  float temps[kMaxTemps];  // ascending inverse temperatures, temps[T-1] = 1
  int maxseg, Dr, D;     // draws per rung; per step (T * Dr + T - 1)
  int smem_floats;       // per-warp float words (2*P*R), rounded
  int smem_bytes;        // per-warp bytes
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float logaddexpf_(float x, float y) {
  float m = fmaxf(x, y);
  return m + log1pf(expf(-fabsf(x - y)));
}

__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t k0,
                                                uint32_t k1, int word) {
  uint32_t c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t lo0 = c0 * 0xD2511F53u, hi0 = __umulhi(c0, 0xD2511F53u);
    uint32_t lo1 = c2 * 0xCD9E8D57u, hi1 = __umulhi(c2, 0xCD9E8D57u);
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return word == 0 ? c0 : word == 1 ? c1 : word == 2 ? c2 : c3;
}

struct Chain {
  const Params* p;
  int c, lane, s;
  int rung_off;          // first draw index of this rung: rung * Dr
  const float* tab;      // DM prior's t(d), d = 0..P, or null (flat)
  float alpha;
  const float* lr;
  const float* cnt;
  const int* nall;
  float* rh;
  float* rhi;
  int8_t* g;
  int8_t* seg;

  __device__ float lrv(int j, int a, int r) const {
    return __ldg(lr + ((size_t)(j * p->A + a)) * p->R + r);
  }
  // draw `idx` of the step, over all rungs and swaps
  __device__ float uni_at(int step, int idx) const {
    if (p->noise) return __ldg(p->noise + ((size_t)step * p->D + idx) * p->C + c);
    uint32_t seed_lo = (uint32_t)p->seed;
    uint32_t seed_hi = (uint32_t)(p->seed >> 32);
    uint32_t bits = philox_word((uint32_t)step, (uint32_t)(idx >> 2), seed_hi,
                                seed_lo, (uint32_t)c, idx & 3);
    return fmaxf((float)(bits >> 9) * (1.0f / 8388608.0f), 1e-12f);
  }
  // draw `d` of this rung's step
  __device__ float uni(int step, int d) const { return uni_at(step, rung_off + d); }
};

// t(d) = sum_{k<d} log(alpha + k) - log d! for d = 0..P, added and
// subtracted in the JAX kernel's order (t_of in _make_full_kernel)
template <int P>
__device__ void prior_table(float alpha, float* tab) {
  float la[P];
#pragma unroll
  for (int k = 0; k < P; ++k) la[k] = logf(alpha + (float)k);
  tab[0] = 0.f;
#pragma unroll
  for (int d = 1; d <= P; ++d) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = __fadd_rn(s, la[k]);
    for (int m = 2; m <= d; ++m) s = __fsub_rn(s, logf((float)m));
    tab[d] = s;
  }
}

// prior_S: t(d) of each distinct row in row order; eq[h] bit j set when
// rows h and j are equal over the whole genotype (eq symmetric, eq[h]
// bit h set)
template <int P>
__device__ float prior_sum(const uint32_t* eq, const float* tab) {
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < P; ++h)
    if ((eq[h] & ((1u << h) - 1u)) == 0u) s = __fadd_rn(s, tab[__popc(eq[h])]);
  return s;
}

// prior_S of the genotype after option (a, b) of KIND: row i becomes row
// src[i] inside the interval and stays row i outside it.  Not inlined,
// like count_options: it runs once per valid option.
template <int P, int KIND>
__device__ __noinline__ float option_prior(const uint32_t* eq_in, const uint32_t* eq_out,
                                           int a, int b, const float* tab) {
  int src[P];
#pragma unroll
  for (int i = 0; i < P; ++i) src[i] = i;
  src[a] = b;
  if (KIND == 0) src[b] = a;
  uint32_t eq[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (((eq_in[src[i]] >> src[j]) & 1u) && ((eq_out[i] >> j) & 1u)) m |= 1u << j;
    eq[i] = m;
  }
  return prior_sum<P>(eq, tab);
}

// prior_S of the chain's current genotype (the swaps' cached prior)
template <int P>
__device__ float genotype_prior(const Chain& ch) {
  const int NB = ch.p->NB;
  uint32_t eq[P];
#pragma unroll
  for (int i = 0; i < P; ++i) eq[i] = 1u << i;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j2 = i + 1; j2 < P; ++j2) {
      bool same = true;
      for (int j = 0; j < NB; ++j) same = same && ch.g[i * NB + j] == ch.g[j2 * NB + j];
      if (same) { eq[i] |= 1u << j2; eq[j2] |= 1u << i; }
    }
  }
  return prior_sum<P>(eq, ch.tab);
}

// sum_r counts * (logsumexp_h rh[h][r] - log P) over the chain's rows
template <int P>
__device__ float full_llk(const Chain& ch, float log_p) {
  const int R = ch.p->R;
  float part = 0.f;
  for (int r = ch.lane; r < R; r += 32) {
    float m = ch.rh[r];
#pragma unroll
    for (int h = 1; h < P; ++h) m = fmaxf(m, ch.rh[h * R + r]);
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < P; ++h) acc += expf(ch.rh[h * R + r] - m);
    part += __ldg(ch.cnt + r) * ((m + logf(acc)) - log_p);
  }
  return warp_sum(part);
}

template <int P>
__device__ void rebuild_rh(const Chain& ch) {
  const int R = ch.p->R, NB = ch.p->NB;
  for (int r = ch.lane; r < R; r += 32) {
#pragma unroll
    for (int h = 0; h < P; ++h) {
      float acc = 0.f;
      for (int j = 0; j < NB; ++j) acc += ch.lrv(j, ch.g[h * NB + j], r);
      ch.rh[h * R + r] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// mutation sweep
// ---------------------------------------------------------------------------

// One sweep at inverse temperature temp: each MH ratio is
// (llk' - llk [+ DM prior ratio]) * temp + log proposal ratio, with the
// product and sum rounded separately (no FMA), as the plain version
// computes them.  At temp = 1, x * 1 is exact, so a flat single-rung
// chain is the same as without the factor.
template <int P>
__device__ float mutation_sweep(const Chain& ch, int step, float llk, float log_p,
                                float temp) {
  const Params& p = *ch.p;
  const int R = p.R, NB = p.NB, A = p.A;
  float* rest = ch.rhi;  // rhi row 0 is free during the mutation sweep
#pragma unroll 1
  for (int h = 0; h < P; ++h) {
    // logsumexp over the other rows is invariant across row h's sites
    for (int r = ch.lane; r < R; r += 32) {
      float v = kNegBig;
      if (P > 1) {
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (i != h) m = fmaxf(m, ch.rh[i * R + r]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (i != h) acc += expf(ch.rh[i * R + r] - m);
        v = m + logf(acc);
      }
      rest[r] = v;
    }
    // d[h2]: positions where row h2 equals row h, kept incrementally
    int d[P];
#pragma unroll
    for (int h2 = 0; h2 < P; ++h2) {
      int n = 0;
      for (int j = 0; j < NB; ++j) n += ch.g[h2 * NB + j] == ch.g[h * NB + j];
      d[h2] = n;
    }
#pragma unroll 1
    for (int j = 0; j < NB; ++j) {
      const int cur = ch.g[h * NB + j];
      const int nall_j = __ldg(ch.nall + j);
      int colv[P];
      bool eqj[P], eq_ex[P];
#pragma unroll
      for (int h2 = 0; h2 < P; ++h2) {
        colv[h2] = ch.g[h2 * NB + j];
        eqj[h2] = colv[h2] == cur;
        eq_ex[h2] = (h2 != h) && (d[h2] - (int)eqj[h2] >= NB - 1);
      }
      const float u = ch.uni(step, h * NB + j);
      int new_a = cur;
      bool moved = false;
      if (nall_j <= 1) {
        // fixed position: no alternative allele (zero acceptance)
      } else if (A == 2) {
        const int alt = 1 - cur;
        float part = 0.f;
        for (int r = ch.lane; r < R; r += 32) {
          float b = ch.rh[h * R + r] - ch.lrv(j, cur, r);
          float cand = logaddexpf_(rest[r], b + ch.lrv(j, alt, r));
          part += __ldg(ch.cnt + r) * (cand - log_p);
        }
        const float llk_alt = warp_sum(part);
        float count_cur = 1.f, count_alt = 1.f;
#pragma unroll
        for (int h2 = 0; h2 < P; ++h2) {
          if (eq_ex[h2]) {
            if (eqj[h2]) count_cur += 1.f; else count_alt += 1.f;
          }
        }
        float dl = llk_alt - llk;
        if (ch.tab)
          dl = __fadd_rn(dl, __fsub_rn(__fadd_rn(__fsub_rn(logf(count_cur), logf(count_alt)),
                                                 logf(__fadd_rn(count_alt - 1.f, ch.alpha))),
                                       logf(__fadd_rn(count_cur - 1.f, ch.alpha))));
        const float mh = __fadd_rn(__fmul_rn(dl, temp), logf(count_alt)) - logf(count_cur);
        const float p_acc = nall_j > 1 ? expf(fminf(0.f, mh)) : 0.f;
        if (u < p_acc) {
          moved = true;
          new_a = alt;
          llk = llk_alt;
        }
      } else {
        float count_cur = 1.f;
#pragma unroll
        for (int h2 = 0; h2 < P; ++h2)
          if (eq_ex[h2] && colv[h2] == cur) count_cur += 1.f;
        int n_opt = 0;
        for (int a = 0; a < A; ++a) n_opt += (a < nall_j) && (a != cur) && (nall_j > 1);
        const float n_opt1 = fmaxf((float)n_opt, 1.f);
        // inverse-CDF walk: the first option whose cumulative mass
        // exceeds u (zero-mass options never stop the walk)
        float acc = 0.f, chosen_llk = 0.f;
        int chosen = -1;
        for (int a = 0; a < A; ++a) {
          const bool valid = (a < nall_j) && (a != cur) && (nall_j > 1);
          if (!valid) continue;
          float part = 0.f;
          for (int r = ch.lane; r < R; r += 32) {
            float b = ch.rh[h * R + r] - ch.lrv(j, cur, r);
            float cand = logaddexpf_(rest[r], b + ch.lrv(j, a, r));
            part += __ldg(ch.cnt + r) * (cand - log_p);
          }
          const float llk_a = warp_sum(part);
          float count_a = 1.f;
#pragma unroll
          for (int h2 = 0; h2 < P; ++h2)
            if (eq_ex[h2] && colv[h2] == a) count_a += 1.f;
          float dl = llk_a - llk;
          if (ch.tab)
            dl = __fadd_rn(dl, __fsub_rn(__fadd_rn(__fsub_rn(logf(count_cur), logf(count_a)),
                                                   logf(__fadd_rn(count_a - 1.f, ch.alpha))),
                                         logf(__fadd_rn(count_cur - 1.f, ch.alpha))));
          const float mh = __fadd_rn(__fmul_rn(dl, temp), logf(count_a)) - logf(count_cur);
          acc += expf(fminf(0.f, mh)) / n_opt1;
          if (chosen < 0 && acc > u) { chosen = a; chosen_llk = llk_a; }
        }
        if (u < acc && chosen >= 0) {
          moved = true;
          new_a = chosen;
          llk = chosen_llk;
        }
      }
      if (moved) {
        for (int r = ch.lane; r < R; r += 32) {
          float b = ch.rh[h * R + r] - ch.lrv(j, cur, r);
          ch.rh[h * R + r] = b + ch.lrv(j, new_a, r);
        }
#pragma unroll
        for (int h2 = 0; h2 < P; ++h2)
          if (h2 != h) d[h2] += (int)(colv[h2] == new_a) - (int)eqj[h2];
        __syncwarp();
        if (ch.lane == 0) ch.g[h * NB + j] = (int8_t)new_a;
        __syncwarp();
      }
    }
  }
  return llk;
}

// ---------------------------------------------------------------------------
// structural MH steps (recombination: KIND 0; dosage: KIND 1)
// ---------------------------------------------------------------------------

template <int P, int KIND>
struct Options {
  static constexpr int K = KIND == 0 ? P * (P - 1) / 2 : P * (P - 1);
  __device__ static constexpr int a_of(int k) {
    if (KIND == 0) {
      int a = 0, n = P - 1;
      while (k >= n) { k -= n; ++a; --n; }
      return a;
    }
    return k / (P - 1);
  }
  __device__ static constexpr int b_of(int k) {
    if (KIND == 0) {
      int a = 0, n = P - 1;
      while (k >= n) { k -= n; ++a; --n; }
      return a + 1 + k;
    }
    int a = k / (P - 1), r = k % (P - 1);
    return r < a ? r : r + 1;
  }
};

// lowest set bit of m (m != 0)
__device__ __forceinline__ int first_bit(uint32_t m) { return __ffs(m) - 1; }

// Valid options of KIND given per-row labels inside (li) and outside
// (lo) the interval: reference recombination_n_options /
// dosage_n_options.  Returns the count; sets bit k of *mask for each
// valid option k.  Not inlined: it runs once per option per MH step, and
// inlining it K times per call site makes the kernel too large to build.
template <int P, int KIND>
__device__ __noinline__ int count_options(const int* li, const int* lo,
                                          uint64_t* mask) {
  uint32_t eq_in[P], eq_full[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    eq_in[i] = 0; eq_full[i] = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (li[i] == li[j]) {
        eq_in[i] |= 1u << j;
        if (lo[i] == lo[j]) eq_full[i] |= 1u << j;
      }
    }
  }
  int n = 0;
  uint64_t m = 0;
#pragma unroll 1
  for (int k = 0; k < Options<P, KIND>::K; ++k) {
    const int a = Options<P, KIND>::a_of(k), b = Options<P, KIND>::b_of(k);
    const bool ne_in = !((eq_in[a] >> b) & 1u);
    bool v;
    if (KIND == 0) {
      v = first_bit(eq_full[a]) == a && first_bit(eq_full[b]) == b && ne_in &&
          lo[a] != lo[b];
    } else {
      const int sd_a = first_bit(eq_in[a]) == a ? __popc(eq_in[a]) : 0;
      v = first_bit(eq_full[a]) == a && sd_a != 1 && first_bit(eq_in[b]) == b && ne_in;
    }
    if (v) { ++n; m |= 1ull << k; }
  }
  if (mask) *mask = m;
  return n;
}

// rows0 = rh, interval sums RI(h) = rhi[perm[h]] (FULL: RI = rh); each MH
// log ratio is (llk' - llk [+ DM prior ratio]) * temp + proposal ratio.
template <int P, int KIND, bool FULL>
__device__ float structural_mh(const Chain& ch, int seg_id, int len_in, bool gate,
                               float u, float llk, float log_p, float temp, int perm[P]) {
  using O = Options<P, KIND>;
  constexpr int K = O::K;
  const Params& p = *ch.p;
  const int R = p.R, NB = p.NB;
  // row equality inside / outside the interval
  uint32_t eq_in[P], eq_out[P];
#pragma unroll
  for (int i = 0; i < P; ++i) { eq_in[i] = 1u << i; eq_out[i] = 1u << i; }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j2 = i + 1; j2 < P; ++j2) {
      int d_in = 0, d_all = 0;
      for (int j = 0; j < NB; ++j) {
        const int e = ch.g[i * NB + j] == ch.g[j2 * NB + j];
        d_all += e;
        if (FULL || ch.seg[j] == seg_id) d_in += e;
      }
      if (d_in >= len_in) { eq_in[i] |= 1u << j2; eq_in[j2] |= 1u << i; }
      if (d_all - d_in >= NB - len_in) { eq_out[i] |= 1u << j2; eq_out[j2] |= 1u << i; }
    }
  }
  int lab_in[P], lab_out[P];
#pragma unroll
  for (int h = 0; h < P; ++h) { lab_in[h] = first_bit(eq_in[h]); lab_out[h] = first_bit(eq_out[h]); }

  uint64_t valid = 0;
  const int n_options = count_options<P, KIND>(lab_in, lab_out, &valid);
  if (!gate || n_options == 0) return llk;
  float s_cur = 0.f;
  if (ch.tab) {
    uint32_t eq_full[P];
#pragma unroll
    for (int h = 0; h < P; ++h) eq_full[h] = eq_in[h] & eq_out[h];
    s_cur = prior_sum<P>(eq_full, ch.tab);
  }

  // one pass over reads: every valid option's candidate term
  float part[K];
#pragma unroll
  for (int k = 0; k < K; ++k) part[k] = 0.f;
  for (int r = ch.lane; r < R; r += 32) {
    float rows[P], ri[P], e[P];
#pragma unroll
    for (int h = 0; h < P; ++h) {
      rows[h] = ch.rh[h * R + r];
      ri[h] = FULL ? rows[h] : ch.rhi[perm[h] * R + r];
    }
    float m = rows[0];
#pragma unroll
    for (int h = 1; h < P; ++h) m = fmaxf(m, rows[h]);
#pragma unroll
    for (int h = 0; h < P; ++h) e[h] = expf(rows[h] - m);
    const float c = __ldg(ch.cnt + r);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!((valid >> k) & 1ull)) continue;
      const int a = O::a_of(k), b = O::b_of(k);
      float cand;
      if (KIND == 0) {
        float se = 0.f;
        bool first = true;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          if (h == a || h == b) continue;
          se = first ? e[h] : se + e[h];
          first = false;
        }
        const float rest = logf(fmaxf(se, 1e-30f)) + m;
        const float row_a = rows[a] - ri[a] + ri[b];
        const float row_b = rows[b] - ri[b] + ri[a];
        cand = logaddexpf_(logaddexpf_(row_a, row_b), rest);
      } else {
        float se = 0.f;
        bool first = true;
#pragma unroll
        for (int h = 0; h < P; ++h) {
          if (h == a) continue;
          se = first ? e[h] : se + e[h];
          first = false;
        }
        if (FULL) {
          cand = logf(fmaxf(se + e[b], 1e-30f)) + m;
        } else {
          const float row_a = rows[a] - ri[a] + ri[b];
          cand = logaddexpf_(row_a, logf(fmaxf(se, 1e-30f)) + m);
        }
      }
      part[k] += c * (cand - log_p);
    }
  }

  // MH acceptance with the n_options / n_return proposal correction
  const float n_opt1 = fmaxf((float)n_options, 1.f);
  float acc = 0.f, chosen_llk = 0.f;
  int chosen = -1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!((valid >> k) & 1ull)) continue;
    const float llk_k = warp_sum(part[k]);
    const int a = O::a_of(k), b = O::b_of(k);
    int li[P];
#pragma unroll
    for (int h = 0; h < P; ++h) li[h] = lab_in[h];
    if (KIND == 0) { li[a] = lab_in[b]; li[b] = lab_in[a]; } else { li[a] = lab_in[b]; }
    const int n_return = count_options<P, KIND>(li, lab_out, nullptr);
    const float lp = logf(n_opt1) - logf(fmaxf((float)n_return, 1.f));
    float dl = llk_k - llk;
    if (ch.tab) dl = __fadd_rn(dl, __fsub_rn(option_prior<P, KIND>(eq_in, eq_out, a, b, ch.tab), s_cur));
    const float mh = __fadd_rn(__fmul_rn(dl, temp), lp);
    acc += expf(fminf(0.f, mh)) / n_opt1;
    if (chosen < 0 && acc > u) { chosen = k; chosen_llk = llk_k; }
  }
  if (!(u < acc) || chosen < 0) return llk;

  // apply: rows copy within the interval
  const int a = O::a_of(chosen), b = O::b_of(chosen);
  __syncwarp();
  for (int j = ch.lane; j < NB; j += 32) {
    if (!FULL && ch.seg[j] != seg_id) continue;
    const int8_t ga = ch.g[a * NB + j], gb = ch.g[b * NB + j];
    ch.g[a * NB + j] = gb;
    if (KIND == 0) ch.g[b * NB + j] = ga;
  }
  for (int r = ch.lane; r < R; r += 32) {
    if (FULL) {
      ch.rh[a * R + r] = ch.rh[b * R + r];
    } else {
      const float ria = ch.rhi[perm[a] * R + r], rib = ch.rhi[perm[b] * R + r];
      const float ra = ch.rh[a * R + r], rb = ch.rh[b * R + r];
      ch.rh[a * R + r] = ra - ria + rib;
      if (KIND == 0) ch.rh[b * R + r] = rb - rib + ria;
    }
  }
  __syncwarp();
  if (KIND == 0) { const int t = perm[a]; perm[a] = perm[b]; perm[b] = t; }
  else { perm[a] = perm[b]; }
  return chosen_llk;
}

// Point the chain's state at shared-memory slot `slot`.
template <int P>
__device__ void bind_slot(Chain& ch, unsigned char* smem, int slot) {
  const Params& p = *ch.p;
  ch.rh = reinterpret_cast<float*>(smem + (size_t)slot * p.smem_bytes);
  ch.rhi = ch.rh + P * p.R;
  ch.g = reinterpret_cast<int8_t*>(ch.rh + p.smem_floats);
  ch.seg = ch.g + P * p.NB;
}

// Chain c's view of its problem and of its warp's shared memory, with
// the genotype loaded from g_init.
template <int P>
__device__ Chain load_chain(const Params& p, unsigned char* smem, int warp, int c) {
  Chain ch;
  ch.p = &p;
  ch.c = c;
  ch.lane = threadIdx.x & 31;
  ch.s = p.problem[c];
  ch.rung_off = 0;
  ch.tab = nullptr;
  ch.alpha = 0.f;
  const int R = p.R, NB = p.NB, A = p.A;
  ch.lr = p.lr + (size_t)ch.s * NB * A * R;
  ch.cnt = p.counts + (size_t)ch.s * R;
  ch.nall = p.nall + (size_t)ch.s * NB;
  bind_slot<P>(ch, smem, warp);
  for (int i = ch.lane; i < P * NB; i += 32)
    ch.g[i] = (int8_t)p.g_init[(size_t)i * p.C + c];
  __syncwarp();
  return ch;
}

// The T rung-warps of chain `cib` of the block meet here.
__device__ __forceinline__ void chain_barrier(int cib, int T) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + cib), "r"(32 * T) : "memory");
}

// K1's chain loop.  LADDER false: one rung at temp 1 and the flat prior,
// known at compile time; true: p.T rungs and, with p.alpha, the prior.
template <int P, bool LADDER>
__device__ __forceinline__ void denovo_chain(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int T = LADDER ? p.T : 1;
  const int rung = warp % T, cib = warp / T;  // rung of chain cib of the block
  const int c = blockIdx.x * (p.warps / T) + cib;
  // the chain's T warps leave together; its barriers are its own
  if (c >= p.C) return;

  Chain ch = load_chain<P>(p, smem, warp, c);
  ch.rung_off = rung * p.Dr;
  const float temp = LADDER ? p.temps[rung] : 1.f;
  float tab[P + 1];
  if (LADDER && p.alpha) {
    ch.alpha = __ldg(p.alpha + ch.s);
    prior_table<P>(ch.alpha, tab);
    ch.tab = tab;
  }
  // swap state of chain cib: slot, llk and prior of each rung
  int* sw_slot = reinterpret_cast<int*>(smem + (size_t)p.warps * p.smem_bytes) + 3 * T * cib;
  float* sw_llk = reinterpret_cast<float*>(sw_slot + T);
  float* sw_pri = sw_llk + T;
  if (LADDER && T > 1 && ch.lane == 0) sw_slot[rung] = warp;

  const int R = p.R, NB = p.NB, A = p.A;
  const float pb = __ldg(p.pbreak + ch.s);
  const float log_p = logf((float)P);
  int basev = 2;  // packing radix next_pow2(max(A, 2))
  while (basev < A) basev <<= 1;

  const int brk0 = P * NB + 2;
  const int seg0 = brk0 + NB - 1;
  const int full0 = seg0 + 2 * p.maxseg;
  float llk = 0.f;
#pragma unroll 1
  for (int step = 0; step < p.n_steps; ++step) {
    if (step % p.refresh == 0) {
      rebuild_rh<P>(ch);
      llk = full_llk<P>(ch, log_p);
    }
    llk = mutation_sweep<P>(ch, step, llk, log_p, temp);

    if constexpr (P > 1) {
    if (p.stage >= 2) {
      const bool gate_r = ch.uni(step, P * NB) <= p.p_recomb;
      const bool gate_d = ch.uni(step, P * NB + 1) <= p.p_partial;
      __syncwarp();
      if (ch.lane == 0) {
        int acc = 0;
        ch.seg[0] = 0;
        for (int j = 1; j < NB; ++j) {
          acc = min(acc + (ch.uni(step, brk0 + j - 1) < pb ? 1 : 0), p.maxseg - 1);
          ch.seg[j] = (int8_t)acc;
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int i = 0; i < p.maxseg; ++i) {
        int len_in = 0;
        for (int j = 0; j < NB; ++j) len_in += ch.seg[j] == i;
        if (len_in == 0) continue;  // empty interval: no valid option
        const float u_r = ch.uni(step, seg0 + 2 * i);
        const float u_d = ch.uni(step, seg0 + 2 * i + 1);
        for (int r = ch.lane; r < R; r += 32) {
#pragma unroll
          for (int h = 0; h < P; ++h) {
            float acc = 0.f;
            for (int j = 0; j < NB; ++j)
              if (ch.seg[j] == i) acc += ch.lrv(j, ch.g[h * NB + j], r);
            ch.rhi[h * R + r] = acc;
          }
        }
        int perm[P];
#pragma unroll
        for (int h = 0; h < P; ++h) perm[h] = h;
        llk = structural_mh<P, 0, false>(ch, i, len_in, gate_r, u_r, llk, log_p, temp, perm);
        if (p.stage >= 3)
          llk = structural_mh<P, 1, false>(ch, i, len_in, gate_d, u_d, llk, log_p, temp,
                                           perm);
      }
    }
    if (p.stage >= 3) {
      const bool gate_f = ch.uni(step, full0) <= p.p_full;
      int perm[P];
#pragma unroll
      for (int h = 0; h < P; ++h) perm[h] = h;
      llk = structural_mh<P, 1, true>(ch, -1, NB, gate_f, ch.uni(step, full0 + 1), llk,
                                      log_p, temp, perm);
    }
    }  // P > 1

    // neighbour swaps from warm to cold (JAX kernel step 4)
    if (LADDER && T > 1) {
      const float pri = ch.tab ? genotype_prior<P>(ch) : 0.f;
      if (ch.lane == 0) { sw_llk[rung] = llk; sw_pri[rung] = pri; }
      chain_barrier(cib, T);
      if (rung == 0 && ch.lane == 0) {
        for (int t = 1; t < T; ++t) {
          const float u = ch.uni_at(step, T * p.Dr + t - 1);
          const float ex = __fmul_rn(__fsub_rn(__fadd_rn(sw_llk[t - 1], sw_pri[t - 1]),
                                               __fadd_rn(sw_llk[t], sw_pri[t])),
                                     __fsub_rn(p.temps[t], p.temps[t - 1]));
          if (u < expf(fminf(0.f, ex))) {
            const int s0 = sw_slot[t - 1];
            sw_slot[t - 1] = sw_slot[t]; sw_slot[t] = s0;
            const float l0 = sw_llk[t - 1];
            sw_llk[t - 1] = sw_llk[t]; sw_llk[t] = l0;
            const float q0 = sw_pri[t - 1];
            sw_pri[t - 1] = sw_pri[t]; sw_pri[t] = q0;
          }
        }
      }
      chain_barrier(cib, T);
      llk = sw_llk[rung];
      bind_slot<P>(ch, smem, sw_slot[rung]);
      if (rung != T - 1) continue;  // only the cold rung writes the trace
    }

    // trace write: base-packed genotype column per position, and llk
    for (int j = ch.lane; j < NB; j += 32) {
      int v = 0, w = 1;
#pragma unroll
      for (int h = 0; h < P; ++h) { v += ch.g[h * NB + j] * w; w *= basev; }
      const size_t o = ((size_t)step * NB + j) * p.C + c;
      if (p.out_bytes == 1) static_cast<uint8_t*>(p.trace)[o] = (uint8_t)v;
      else if (p.out_bytes == 2) static_cast<int16_t*>(p.trace)[o] = (int16_t)v;
      else static_cast<int32_t*>(p.trace)[o] = v;
    }
    if (ch.lane == 0) p.llks[(size_t)step * p.C + c] = llk;
  }
}

#ifndef K1_LADDER
// the flat single-rung chain, as in the kernel before the ladder
template <int P>
__global__ void __launch_bounds__(128) denovo_kernel(Params p) {
  denovo_chain<P, false>(p);
}
#else
// 1-8 rungs and the optional prior; one resident block per SM lets ptxas
// give P8 its registers (a bare 256 capped it at 128, with spills)
template <int P>
__global__ void __launch_bounds__(256, 1) denovo_ladder_kernel(Params p) {
  denovo_chain<P, true>(p);
}
#endif

int smem_floats_for(int P, int R) { return ((2 * P * R) + 3) / 4 * 4; }

// one rung's slot: rh + rhi (f32) and g + seg (int8), in 16-byte units
int64_t warp_smem_bytes(int P, int R, int NB) {
  const int64_t bytes = (int64_t)smem_floats_for(P, R) * 4 + P * NB + NB;
  return (bytes + 15) / 16 * 16;
}

// one chain: its T rungs' slots and, with more than one rung, the slot
// index, llk and prior of each rung that the swaps exchange
int64_t chain_smem_bytes(int P, int R, int NB, int T) {
  return T * warp_smem_bytes(P, R, NB) + (T > 1 ? 12 * (int64_t)T : 0);
}

template <int P>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  // rung slots of all the block's chains, then each chain's swap state
  const int chains = p.warps / p.T;
  const size_t smem = (size_t)chain_smem_bytes(P, p.R, p.NB, p.T) * chains;
  const int blocks = (p.C + chains - 1) / chains;
#ifdef K1_LADDER
  cudaError_t err = cudaFuncSetAttribute(
      denovo_ladder_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  denovo_ladder_kernel<P><<<blocks, 32 * p.warps, smem, stream>>>(p);
#else
  if (p.T > 1 || p.alpha != nullptr) return cudaErrorInvalidValue;  // the ladder build's
  cudaError_t err = cudaFuncSetAttribute(
      denovo_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  denovo_kernel<P><<<blocks, 32 * p.warps, smem, stream>>>(p);
#endif
  return cudaGetLastError();
}

#ifndef K1_LADDER

// K0: one mutation sweep at inverse temperature temp from a given llk
// (replaces mchap_tpu/ops/pallas_denovo.py::pallas_mutation_sweep, body
// _make_kernel).  rh is rebuilt from the genotype, the sweep is K1's, and
// the genotype, rh and llk are written out.
template <int P>
__global__ void __launch_bounds__(128) mutation_kernel(Params p, const float* llk_in,
                                                       float temp, int* g_out,
                                                       float* rh_out, float* llk_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * p.warps + warp;
  if (c >= p.C) return;

  const Chain ch = load_chain<P>(p, smem, warp, c);
  const int R = p.R, NB = p.NB;
  rebuild_rh<P>(ch);
  const float llk = mutation_sweep<P>(ch, 0, llk_in[c], logf((float)P), temp);
  __syncwarp();
  for (int i = ch.lane; i < P * NB; i += 32) g_out[(size_t)i * p.C + c] = ch.g[i];
  for (int i = ch.lane; i < P * R; i += 32) rh_out[(size_t)i * p.C + c] = ch.rh[i];
  if (ch.lane == 0) llk_out[c] = llk;
}

template <int P>
cudaError_t launch_mutation(const Params& p, const float* llk_in, float temp, int* g_out,
                            float* rh_out, float* llk_out, cudaStream_t stream) {
  const size_t smem = (size_t)chain_smem_bytes(P, p.R, p.NB, 1) * p.warps;
  cudaError_t err = cudaFuncSetAttribute(
      mutation_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.C + p.warps - 1) / p.warps;
  mutation_kernel<P><<<blocks, 32 * p.warps, smem, stream>>>(p, llk_in, temp, g_out,
                                                              rh_out, llk_out);
  return cudaGetLastError();
}
#endif  // K1_LADDER

}  // namespace

extern "C" {

// Shared memory one chain of T rungs needs (T = 1 for K0): the layout
// the launches use; blocks hold warps / T chains.
int64_t denovo_sampler_chain_smem_bytes(int P, int R, int NB, int T) {
  return chain_smem_bytes(P, R, NB, T);
}

const char* denovo_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 entry: alpha [S] or null; temps is a host array of T floats; warps
// per block is a multiple of T.
int denovo_sampler_launch(const void* lr, const void* counts, const void* nall,
                          const void* pbreak, const void* alpha, const void* problem,
                          const void* g_init, const void* noise, void* trace, void* llks,
                          int S, int R, int NB, int A, int P, int C, int n_steps, int T,
                          const float* temps, float p_recomb, float p_partial,
                          float p_full, int refresh, int stage, int out_bytes,
                          uint64_t seed, int warps, void* stream) {
  if (T < 1 || T > kMaxTemps || warps % T != 0 || (T > 1 && warps / T > 15))
    return cudaErrorInvalidValue;
  Params p = {};
  p.lr = static_cast<const float*>(lr);
  p.counts = static_cast<const float*>(counts);
  p.nall = static_cast<const int*>(nall);
  p.pbreak = static_cast<const float*>(pbreak);
  p.alpha = static_cast<const float*>(alpha);
  p.problem = static_cast<const int*>(problem);
  p.g_init = static_cast<const int*>(g_init);
  p.noise = static_cast<const float*>(noise);
  p.trace = trace;
  p.llks = static_cast<float*>(llks);
  p.S = S; p.R = R; p.NB = NB; p.A = A; p.C = C; p.n_steps = n_steps;
  p.p_recomb = p_recomb; p.p_partial = p_partial; p.p_full = p_full;
  p.refresh = refresh; p.stage = stage; p.out_bytes = out_bytes;
  p.seed = seed;
  p.warps = warps;
  p.T = T;
  for (int t = 0; t < T; ++t) p.temps[t] = temps[t];
  p.maxseg = NB / 4 + 2 < NB ? NB / 4 + 2 : NB;
  if (p.maxseg < 2) p.maxseg = 2;
  p.Dr = P * NB + 2 + (NB - 1) + 2 * p.maxseg + 2;
  p.D = T * p.Dr + T - 1;
  p.smem_floats = smem_floats_for(P, R);
  p.smem_bytes = (int)warp_smem_bytes(P, R, NB);
  if (C == 0 || n_steps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_p<1>(p, s);
    case 2: return launch_p<2>(p, s);
    case 3: return launch_p<3>(p, s);
    case 4: return launch_p<4>(p, s);
    case 5: return launch_p<5>(p, s);
    case 6: return launch_p<6>(p, s);
    case 7: return launch_p<7>(p, s);
    case 8: return launch_p<8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

#ifndef K1_LADDER
// K0 entry: lr [S][NB][A][R], counts [S][R], nall [S][NB], problem [C],
// g_init [P][NB][C], llk_in [C], noise [P*NB][C] or null; writes g_out
// [P][NB][C], rh_out [P][R][C] and llk_out [C].
int mutation_sweep_launch(const void* lr, const void* counts, const void* nall,
                          const void* problem, const void* g_init, const void* noise,
                          const void* llk_in, void* g_out, void* rh_out, void* llk_out,
                          int S, int R, int NB, int A, int P, int C, float temp,
                          uint64_t seed, int warps, void* stream) {
  Params p = {};
  p.lr = static_cast<const float*>(lr);
  p.counts = static_cast<const float*>(counts);
  p.nall = static_cast<const int*>(nall);
  p.problem = static_cast<const int*>(problem);
  p.g_init = static_cast<const int*>(g_init);
  p.noise = static_cast<const float*>(noise);
  p.S = S; p.R = R; p.NB = NB; p.A = A; p.C = C; p.n_steps = 1;
  p.seed = seed;
  p.warps = warps;
  p.T = 1;
  p.temps[0] = 1.f;
  p.Dr = p.D = P * NB;  // the sweep's draws: site (h, j) -> h * NB + j
  p.smem_floats = smem_floats_for(P, R);
  p.smem_bytes = (int)warp_smem_bytes(P, R, NB);
  if (C == 0) return cudaSuccess;
  const float* li = static_cast<const float*>(llk_in);
  int* go = static_cast<int*>(g_out);
  float* ro = static_cast<float*>(rh_out);
  float* lo = static_cast<float*>(llk_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_mutation<1>(p, li, temp, go, ro, lo, s);
    case 2: return launch_mutation<2>(p, li, temp, go, ro, lo, s);
    case 3: return launch_mutation<3>(p, li, temp, go, ro, lo, s);
    case 4: return launch_mutation<4>(p, li, temp, go, ro, lo, s);
    case 5: return launch_mutation<5>(p, li, temp, go, ro, lo, s);
    case 6: return launch_mutation<6>(p, li, temp, go, ro, lo, s);
    case 7: return launch_mutation<7>(p, li, temp, go, ro, lo, s);
    case 8: return launch_mutation<8>(p, li, temp, go, ro, lo, s);
    default: return cudaErrorInvalidValue;
  }
}

#endif  // K1_LADDER

}  // extern "C"
