// K1: the de novo assembly sampler for Hopper (sm_90a).
//
// Replaces mchap_tpu/ops/pallas_denovo.py::pallas_denovo_sampler (kernel
// body _make_full_kernel, :270).  It computes the same Markov chain per
// chain: mutation sweep (systematic h-major site order, haplotype-copy
// proposal correction, a binary fast path) -> gate_r, gate_d -> Bernoulli
// breaks for j = 1..NB-1 -> per segment a recombination MH then a dosage
// MH on the permuted interval sums -> gate_f -> full-length dosage MH; rh
// rebuilt every `refresh` steps; base-next_pow2(A) packed trace.  The
// plain PyTorch version is mchap_tpu_torch/ops/cuda_denovo.py::
// denovo_sampler_plain, which consumes uniform draws in the same order
// and adds in the same order, so pinned noise gives the same chain.
//
// A second entry, mutation_sweep_launch, is K0: it replaces
// mchap_tpu/ops/pallas_denovo.py::pallas_mutation_sweep (body _make_kernel)
// with one call of the same mutation-sweep device code at an inverse
// temperature, starting from a given llk (plain version:
// cuda_denovo.py::mutation_sweep_plain).  K1 runs that code at temp = 1.
//
// What bounds it on this card: each chain is a long sequence of dependent
// MH decisions, and every decision waits on a sum over reads (R = 64 at
// typical depth) of logaddexp terms.  The work is the latency of those
// dependent reductions and of expf/logf, and the instructions issued per
// decision, not bandwidth: the per-problem log-read tensor lr[S, NB, A, R]
// is shared by all chains of a problem and read from L1/L2.  A clock64()
// profile of the earlier design (mchap_tpu_torch/profile_k1.py) put most
// of a chain-step in per-chain scalar work that all 32 lanes repeated:
// each site's Philox draw, serial loops over positions (row equality for
// 13 structural MHs a step, per-row match counts, interval sums that
// tested every position for every segment, the break draws in one lane),
// and an option-count call per structural option.
//
// Layout: one warp per chain rung, as before, with lanes striding over
// reads; every sum over reads is a 5-step xor-butterfly of shuffles, so
// all lanes hold the bitwise-identical total and take the same decision.
// What was per-chain scalar work is now spread over the lanes:
// - a lane draws the uniforms of 32 consecutive mutation sites at once
//   (one Philox per lane, then one shuffle per site);
// - positions are spread over lanes for row comparisons: each lane builds
//   per-row difference masks over its positions and one __reduce_or_sync
//   per row gives the row-equality masks inside and outside an interval;
//   per-row match counts use __reduce_add_sync;
// - the break draws are a ballot and a prefix count; segments are kept as
//   their bounds, and the interval sums walk only a segment's positions
//   (in the same order, so the same f32 sums);
// - structural options are spread over lanes: lane k tests option k and
//   counts its reverse moves from bit masks in closed form (no option
//   loop), and computes its proposal and prior terms; a ballot lists the
//   valid options.
// The valid options' read terms are accumulated in groups of G per pass
// over reads, so no register array grows with the option count: this is
// what lets ploidy run to 12 (K = 132 dosage options).  Kernels are
// instantiated for a largest ploidy of 4, 8 and 12 with the ploidy a
// runtime bound inside, so register arrays keep compile-time indices.
// Small integers' logs (and the prior's log(count - 1 + alpha)) come
// from per-warp tables computed with the same logf.
//
// State: a rung's slot holds rh[P][R] and the interval sums rhi[P][R]
// (f32) and the genotype g[P][NB] (int8); each warp also has an aux
// block (log tables, the prior's t(d), the segment bounds).  Slots live
// in shared memory when all of a chain's rungs fit one block, and
// otherwise in a per-chain scratch buffer in device memory that the
// wrapper allocates (denovo_sampler_state_layout gives the bytes and the
// place, and the launch uses the same function), so any read depth the
// card's memory holds runs.  Uniform draws come from Philox4x32-10, key
// (seed, chain_offset + chain), counter (step, draw index), or from a
// pinned noise[n_steps][D][C] tensor in tests.  chain_offset is the
// launch's first chain in the whole block, so a block split over devices
// or processes draws what one launch of the whole block draws.
//
// Tempering (the JAX kernel's n_temps > 1): a chain's T rungs are T
// consecutive warps of one block, rung t drawing from indices t * Dr ..
// and scaling every MH log ratio by temps[t].  After each step the rungs
// meet at a named barrier of their own (bar.sync 1 + chain, 32 * T), one
// lane runs the warm-to-cold neighbour swaps, exchanging the rungs' slot
// indices, llks and priors (rh and g stay where they are), and a second
// barrier hands each rung its new slot.  Only the cold rung writes the
// trace.  The ladder and the prior run in their own instance
// (denovo_ladder_kernel, 8-warp blocks for T = 8); the flat single-rung
// chain keeps an instance without them (denovo_kernel).  The source is
// built twice, at once: by default into the library of denovo_kernel and
// K0, and with -DK1_LADDER into that of denovo_ladder_kernel; both export
// denovo_sampler_launch.  K0 shares the mutation-sweep code and the state
// layout.
//
// Dirichlet-multinomial prior (the JAX kernel's use_prior): with per-
// problem dispersions alpha, the mutation ratio gains log(count_cur) -
// log(count_a) + log(count_a - 1 + alpha) - log(count_cur - 1 + alpha),
// and each structural option prior_S(new) - prior_S(cur), prior_S summing
// t(d) = sum_{k<d} log(alpha + k) - log d! over the distinct rows of
// dosage d, read from full-row equality masks.  Both sit inside the
// temperature factor, in the JAX kernel's f32 operation order.
//
// Sums that the plain version repeats are written with __fadd_rn /
// __fmul_rn where nvcc could otherwise contract them into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#ifdef K1_PROFILE  // mchap_tpu_torch/profile_k1.py defines MARK and PROF_ADD
#define PROF(...) __VA_ARGS__
#else
#define PROF(...)
#endif

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTemps = 8;
constexpr int kMaxPloidy = 12;
constexpr int64_t kMaxSmem = 232448;  // bytes a block may use (227 KB)
constexpr int kTab = 16;              // entries of each per-warp table

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
  unsigned char* scratch;  // per-chain slots when they do not fit shared memory
  int S, R, NB, A, C, n_steps, P;
  float p_recomb, p_partial, p_full;
  int refresh, stage, out_bytes;
  uint64_t seed;
  uint32_t chain_offset;  // global index of chain 0 (the Philox key)
  int warps;             // rung-warps per block: whole chains of T warps
  int T;                 // rungs per chain
  float temps[kMaxTemps];  // ascending inverse temperatures, temps[T-1] = 1
  int maxseg, Dr, D;     // draws per rung; per step (T * Dr + T - 1)
  int64_t slot_bytes, aux_bytes, swap_bytes;  // per rung, per warp, per chain
  int in_smem;           // slots in shared memory (1) or in scratch (0)
};

// ---------------------------------------------------------------------------
// state layout: one definition, used by the launches and exported
// ---------------------------------------------------------------------------

struct Layout {
  int64_t slot, aux, swap;  // rung slot, per-warp aux, per-chain swap state
  int64_t smem_chain;       // shared memory per chain
  int64_t scratch_chain;    // device scratch per chain
  int in_smem;
};

int64_t round16(int64_t x) { return (x + 15) / 16 * 16; }

// A rung's slot: rh and rhi f32[P][R], then g int8[P][NB].  A warp's aux:
// three f32 tables of kTab entries (log k, log(k - 1 + alpha), t(d)) and
// the segment bounds, int16[NB + 1].  A tempered chain's swap state: the
// slot index, llk and prior of each rung.  Slots go to shared memory when
// all of a chain's state fits one block, else to scratch.
Layout state_layout(int P, int R, int NB, int T) {
  Layout l;
  l.slot = round16((int64_t)8 * P * R + (int64_t)P * NB);
  l.aux = round16(4 * 3 * kTab + 2 * ((int64_t)NB + 1));
  l.swap = T > 1 ? round16(12 * (int64_t)T) : 0;
  const int64_t all = T * (l.aux + l.slot) + l.swap;
  l.in_smem = all <= kMaxSmem;
  l.smem_chain = l.in_smem ? all : T * l.aux + l.swap;
  l.scratch_chain = l.in_smem ? 0 : T * l.slot;
  return l;
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
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

// x[i] for a runtime i, from a register array (unrolled selects keep the
// array in registers)
template <int N, class V>
__device__ __forceinline__ V pick(const V (&x)[N], int i) {
  V v = x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? x[k] : v;
  return v;
}

// rows below row i as a bit mask (bit k: row k; i < 32)
__device__ __forceinline__ uint32_t below(int i) { return (1u << i) - 1u; }

struct Chain {
  const Params* p;
  int c, lane, s, P;
  int rung_off;          // first draw index of this rung: rung * Dr
  float alpha;
  bool prior;            // Dirichlet-multinomial prior on
  const float* lr;
  const float* cnt;
  const int* nall;
  float* rh;
  float* rhi;
  int8_t* g;
  unsigned char* slots;  // this chain's T slots
  float* logk;           // aux: logf(k)
  float* loga;           // aux: logf(k - 1 + alpha) (prior only)
  float* tab;            // aux: t(d) (prior only)
  int16_t* segb;         // aux: segment starts, then NB

  __device__ float lrv(int j, int a, int r) const {
    return __ldg(lr + ((size_t)(j * p->A + a)) * p->R + r);
  }
  // draw `idx` of the step, over all rungs and swaps
  __device__ float uni_at(int step, int idx) const {
    if (p->noise) return __ldg(p->noise + ((size_t)step * p->D + idx) * p->C + c);
    uint32_t seed_lo = (uint32_t)p->seed;
    uint32_t seed_hi = (uint32_t)(p->seed >> 32);
    uint32_t bits = philox_word((uint32_t)step, (uint32_t)(idx >> 2), seed_hi,
                                seed_lo, p->chain_offset + (uint32_t)c, idx & 3);
    return fmaxf((float)(bits >> 9) * (1.0f / 8388608.0f), 1e-12f);
  }
  // draw `d` of this rung's step
  __device__ float uni(int step, int d) const { return uni_at(step, rung_off + d); }
  // point rh, rhi and g at slot `slot` of the chain
  __device__ void bind(int slot) {
    rh = reinterpret_cast<float*>(slots + (size_t)slot * p->slot_bytes);
    rhi = rh + (size_t)P * p->R;
    g = reinterpret_cast<int8_t*>(rhi + (size_t)P * p->R);
  }
};

// t(d) = sum_{k<d} log(alpha + k) - log d! for d = 0..P, added and
// subtracted in the JAX kernel's order (t_of in _make_full_kernel);
// written by lane 0
__device__ void prior_table(int P, float alpha, float* tab) {
  tab[0] = 0.f;
  for (int d = 1; d <= P; ++d) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = __fadd_rn(s, logf(alpha + (float)k));
    for (int m = 2; m <= d; ++m) s = __fsub_rn(s, logf((float)m));
    tab[d] = s;
  }
}

// prior_S: t(d) of each distinct row in row order; eq[h] bit j set when
// rows h and j are equal over the whole genotype (eq[h] bit h set)
template <int MAXP>
__device__ float prior_sum(const uint32_t (&eq)[MAXP], int P, const float* tab) {
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < MAXP; ++h)
    if (h < P && (eq[h] & below(h)) == 0u) s = __fadd_rn(s, tab[__popc(eq[h])]);
  return s;
}

// Row difference masks over positions [lo, hi) and outside it, reduced
// over the warp: din[i] bit k set when rows i and k differ somewhere
// inside, dout[i] when they differ somewhere outside.  lo = 0, hi = NB
// compares whole rows.
template <int MAXP>
__device__ void row_diffs(const Chain& ch, int lo, int hi, uint32_t (&din)[MAXP],
                          uint32_t (&dout)[MAXP]) {
  const int NB = ch.p->NB, P = ch.P;
  uint32_t w[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) w[i] = 0u;
  for (int j = ch.lane; j < NB; j += 32) {
    int col[MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) col[i] = i < P ? ch.g[i * NB + j] : 0;
    const int shift = (j >= lo && j < hi) ? 0 : 16;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      uint32_t m = 0u;
#pragma unroll
      for (int k = 0; k < MAXP; ++k) m |= (uint32_t)(col[i] != col[k]) << k;
      w[i] |= m << shift;
    }
  }
  const uint32_t rows = below(P);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    const uint32_t v = i < P ? __reduce_or_sync(kFull, w[i]) : 0u;
    din[i] = v & rows;
    dout[i] = (v >> 16) & rows;
  }
}

// prior_S of the chain's current genotype (the swaps' cached prior)
template <int MAXP>
__device__ float genotype_prior(const Chain& ch) {
  uint32_t din[MAXP], dout[MAXP], eq[MAXP];
  row_diffs<MAXP>(ch, 0, ch.p->NB, din, dout);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) eq[i] = ~din[i] & below(ch.P);
  return prior_sum<MAXP>(eq, ch.P, ch.tab);
}

// sum_r counts * (logsumexp_h rh[h][r] - log P) over the chain's rows
__device__ float full_llk(const Chain& ch, float log_p) {
  const int R = ch.p->R, P = ch.P;
  float part = 0.f;
  for (int r = ch.lane; r < R; r += 32) {
    float m = ch.rh[r];
    for (int h = 1; h < P; ++h) m = fmaxf(m, ch.rh[h * R + r]);
    float acc = 0.f;
    for (int h = 0; h < P; ++h) acc += expf(ch.rh[h * R + r] - m);
    part = __fadd_rn(part, __fmul_rn(__ldg(ch.cnt + r), (m + logf(acc)) - log_p));
  }
  return warp_sum(part);
}

// out[h][r] = sum over positions j in [lo, hi), in order, of lr at row
// h's allele: rh when [lo, hi) is every position, else the interval sums
// (rows interleaved for their independent sums)
template <int MAXP>
__device__ void row_sums(const Chain& ch, int lo, int hi, float* out) {
  const int R = ch.p->R, NB = ch.p->NB, P = ch.P;
  for (int r = ch.lane; r < R; r += 32) {
    float acc[MAXP];
#pragma unroll
    for (int h = 0; h < MAXP; ++h) acc[h] = 0.f;
    for (int j = lo; j < hi; ++j) {
#pragma unroll
      for (int h = 0; h < MAXP; ++h)
        if (h < P) acc[h] += ch.lrv(j, ch.g[h * NB + j], r);
    }
#pragma unroll
    for (int h = 0; h < MAXP; ++h)
      if (h < P) out[h * R + r] = acc[h];
  }
}

// ---------------------------------------------------------------------------
// mutation sweep
// ---------------------------------------------------------------------------

// A mutation site's inputs: the row's allele, the position's allele
// count, the column and the site's draw
template <int MAXP>
struct Site {
  int cur, nall;
  int col[MAXP];
  float u;
};

template <int MAXP>
__device__ __forceinline__ void load_site(const Chain& ch, int h, int j, float u,
                                          Site<MAXP>& s) {
  const int NB = ch.p->NB;
  s.cur = ch.g[h * NB + j];
  s.nall = __ldg(ch.nall + j);
#pragma unroll
  for (int h2 = 0; h2 < MAXP; ++h2) s.col[h2] = h2 < ch.P ? ch.g[h2 * NB + j] : -1;
  s.u = u;
}

// One sweep at inverse temperature temp: each MH ratio is
// (llk' - llk [+ DM prior ratio]) * temp + log proposal ratio, with the
// product and sum rounded separately (no FMA), as the plain version
// computes them.  At temp = 1, x * 1 is exact, so a flat single-rung
// chain is the same as without the factor.
template <int MAXP>
__device__ float mutation_sweep(const Chain& ch, int step, float llk, float log_p,
                                float temp) {
  const Params& p = *ch.p;
  const int R = p.R, NB = p.NB, A = p.A, P = ch.P;
  const int sites = P * NB;
  float* rest = ch.rhi;  // rhi row 0 is free during the mutation sweep
  float ub = 0.f;        // this lane's draw of the current window of 32 sites
  int ubase = -32;
  PROF(long long tm = clock64(), a_rest = 0, a_d = 0, a_site = 0, a_cand = 0, a_bfly = 0,
       a_dec = 0;)
#pragma unroll 1
  for (int h = 0; h < P; ++h) {
    // logsumexp over the other rows is invariant across row h's sites
    for (int r = ch.lane; r < R; r += 32) {
      float v = kNegBig;
      if (P > 1) {
        float m = __int_as_float(0xff800000);  // -inf
        for (int i = 0; i < P; ++i)
          if (i != h) m = fmaxf(m, ch.rh[i * R + r]);
        float acc = 0.f;
        for (int i = 0; i < P; ++i)
          if (i != h) acc += expf(ch.rh[i * R + r] - m);
        v = m + logf(acc);
      }
      rest[r] = v;
    }
    PROF(MARKR(a_rest))
    // nd[h2]: positions where row h2 differs from row h, kept incrementally
    int nd[MAXP];
#pragma unroll
    for (int h2 = 0; h2 < MAXP; ++h2) nd[h2] = 0;
    for (int j = ch.lane; j < NB; j += 32) {
      const int gh = ch.g[h * NB + j];
#pragma unroll
      for (int h2 = 0; h2 < MAXP; ++h2)
        if (h2 < P) nd[h2] += ch.g[h2 * NB + j] != gh;
    }
#pragma unroll
    for (int h2 = 0; h2 < MAXP; ++h2)
      if (h2 < P) nd[h2] = __reduce_add_sync(kFull, nd[h2]);
    PROF(MARKR(a_d))
#pragma unroll 1
    for (int j = 0; j < NB; ++j) {
      const int site = h * NB + j;
      if (site - ubase >= 32) {  // the next 32 sites' draws, one per lane
        ubase = site;
        ub = site + ch.lane < sites ? ch.uni(step, site + ch.lane) : 0.f;
      }
      Site<MAXP> st;
      load_site<MAXP>(ch, h, j, __shfl_sync(kFull, ub, site - ubase), st);
      const int cur = st.cur, nall_j = st.nall;
      const float u = st.u;
      bool eq_ex[MAXP];
#pragma unroll
      for (int h2 = 0; h2 < MAXP; ++h2)  // row h2 equals row h everywhere but (perhaps) at j
        eq_ex[h2] = h2 < P && h2 != h && nd[h2] + (int)(st.col[h2] == cur) <= 1;
      PROF(MARKR(a_site))
      int new_a = cur;
      bool moved = false;
      if (nall_j <= 1) {
        // fixed position: no alternative allele (zero acceptance)
      } else if (nall_j == 2) {
        // one alternative: the other of alleles 0 and 1; two of the
        // lane's reads in flight at once, added in turn
        const int alt = 1 - cur;
        float part = 0.f;
        int r = ch.lane;
        for (; r + 32 < R; r += 64) {
          const float b0 = ch.rh[h * R + r] - ch.lrv(j, cur, r);
          const float b1 = ch.rh[h * R + r + 32] - ch.lrv(j, cur, r + 32);
          const float c0 = logaddexpf_(rest[r], b0 + ch.lrv(j, alt, r));
          const float c1 = logaddexpf_(rest[r + 32], b1 + ch.lrv(j, alt, r + 32));
          const float t0 = __fmul_rn(__ldg(ch.cnt + r), c0 - log_p);
          const float t1 = __fmul_rn(__ldg(ch.cnt + r + 32), c1 - log_p);
          part = __fadd_rn(__fadd_rn(part, t0), t1);
        }
        if (r < R) {
          const float b0 = ch.rh[h * R + r] - ch.lrv(j, cur, r);
          const float c0 = logaddexpf_(rest[r], b0 + ch.lrv(j, alt, r));
          part = __fadd_rn(part, __fmul_rn(__ldg(ch.cnt + r), c0 - log_p));
        }
        PROF(MARKR(a_cand))
        const float llk_alt = warp_sum(part);
        PROF(MARKR(a_bfly))
        int n_cur = 1, n_alt = 1;
#pragma unroll
        for (int h2 = 0; h2 < MAXP; ++h2) {
          n_cur += eq_ex[h2] && st.col[h2] == cur;
          n_alt += eq_ex[h2] && st.col[h2] == alt;
        }
        const float lc = ch.logk[n_cur], la = ch.logk[n_alt];
        float dl = llk_alt - llk;
        if (ch.prior)
          dl = __fadd_rn(dl, __fsub_rn(__fadd_rn(__fsub_rn(lc, la), ch.loga[n_alt]),
                                       ch.loga[n_cur]));
        const float mh = __fadd_rn(__fmul_rn(dl, temp), la) - lc;
        if (u < expf(fminf(0.f, mh))) {
          moved = true;
          new_a = alt;
          llk = llk_alt;
        }
      } else {
        // several alternatives: inverse-CDF walk, the first option whose
        // cumulative mass exceeds u (zero-mass options never stop it)
        int n_cur = 1;
#pragma unroll
        for (int h2 = 0; h2 < MAXP; ++h2) n_cur += eq_ex[h2] && st.col[h2] == cur;
        const float lc = ch.logk[n_cur];
        int n_opt = 0;
        for (int a = 0; a < A; ++a) n_opt += (a < nall_j) && (a != cur);
        const float n_opt1 = fmaxf((float)n_opt, 1.f);
        float acc = 0.f, chosen_llk = 0.f;
        int chosen = -1;
        for (int a = 0; a < A; ++a) {
          const bool valid = (a < nall_j) && (a != cur);
          if (!valid) continue;
          float part = 0.f;
          for (int r = ch.lane; r < R; r += 32) {
            float b = ch.rh[h * R + r] - ch.lrv(j, cur, r);
            float cand = logaddexpf_(rest[r], b + ch.lrv(j, a, r));
            part = __fadd_rn(part, __fmul_rn(__ldg(ch.cnt + r), cand - log_p));
          }
          PROF(MARKR(a_cand))
          const float llk_a = warp_sum(part);
          PROF(MARKR(a_bfly))
          int n_a = 1;
#pragma unroll
          for (int h2 = 0; h2 < MAXP; ++h2) n_a += eq_ex[h2] && st.col[h2] == a;
          const float la = ch.logk[n_a];
          float dl = llk_a - llk;
          if (ch.prior)
            dl = __fadd_rn(dl, __fsub_rn(__fadd_rn(__fsub_rn(lc, la), ch.loga[n_a]),
                                         ch.loga[n_cur]));
          const float mh = __fadd_rn(__fmul_rn(dl, temp), la) - lc;
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
        for (int h2 = 0; h2 < MAXP; ++h2)
          if (h2 != h) nd[h2] -= (int)(st.col[h2] == new_a) - (int)(st.col[h2] == cur);
        __syncwarp();
        if (ch.lane == 0) ch.g[h * NB + j] = (int8_t)new_a;
        __syncwarp();
      }
      PROF(MARKR(a_dec))
    }
  }
  PROF(PROF_ADD(1, a_rest) PROF_ADD(2, a_d) PROF_ADD(3, a_site) PROF_ADD(4, a_cand)
       PROF_ADD(5, a_bfly) PROF_ADD(6, a_dec))
  return llk;
}

// ---------------------------------------------------------------------------
// structural MH steps (recombination: KIND 0; dosage: KIND 1)
// ---------------------------------------------------------------------------

// option k of KIND at ploidy P -> rows (a, b): recombination pairs a < b
// in lexicographic order, dosage pairs a != b in a-major order
template <int KIND>
__device__ __forceinline__ void option_rows(int k, int P, int& a, int& b) {
  if (KIND == 0) {
    int n = P - 1;
    a = 0;
    while (k >= n) { k -= n; ++a; --n; }
    b = a + 1 + k;
  } else {
    a = k / (P - 1);
    const int r = k - a * (P - 1);
    b = r < a ? r : r + 1;
  }
}

// Row classes from the inside and outside row-equality masks (ein[i]
// bit k: rows i and k equal inside the interval; eout: outside)
struct Classes {
  uint32_t rep;     // rows first of their full row
  uint32_t fin;     // rows first of their row inside the interval
  uint32_t single;  // rows alone inside the interval
};

template <int MAXP>
__device__ __forceinline__ Classes row_classes(const uint32_t (&ein)[MAXP],
                                               const uint32_t (&eout)[MAXP], int P) {
  Classes k = {0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i >= P) continue;
    k.rep |= (uint32_t)(((ein[i] & eout[i]) & below(i)) == 0u) << i;
    k.fin |= (uint32_t)((ein[i] & below(i)) == 0u) << i;
    k.single |= (uint32_t)(__popc(ein[i]) == 1) << i;
  }
  return k;
}

// Option (a, b) of KIND is valid (reference recombination_n_options /
// dosage_n_options): recombination pairs a < b of distinct full rows that
// differ inside and outside; dosage pairs (a, b) with a the first of its
// full row and not alone inside, b the first of its inside row, a and b
// differing inside.
template <int MAXP, int KIND>
__device__ __forceinline__ bool option_valid(const Classes& k, const uint32_t (&ein)[MAXP],
                                             const uint32_t (&eout)[MAXP], int a, int b) {
  const uint32_t ia = pick(ein, a);
  if (KIND == 0)
    return ((k.rep >> a) & 1u) && ((k.rep >> b) & 1u) && !((ia >> b) & 1u) &&
           !((pick(eout, a) >> b) & 1u);
  return (((k.rep & ~k.single) >> a) & 1u) && ((k.fin >> b) & 1u) && !((ia >> b) & 1u);
}

// the number of valid options of KIND, in closed form over the classes
template <int MAXP, int KIND>
__device__ __forceinline__ int count_valid(const uint32_t (&ein)[MAXP],
                                           const uint32_t (&eout)[MAXP], int P) {
  const Classes k = row_classes<MAXP>(ein, eout, P);
  int n = 0;
#pragma unroll
  for (int a = 0; a < MAXP; ++a) {
    if (a >= P) continue;
    if (KIND == 0) {
      if ((k.rep >> a) & 1u) n += __popc(k.rep & ~ein[a] & ~eout[a] & ~below(a + 1));
    } else {
      if (((k.rep & ~k.single) >> a) & 1u) n += __popc(k.fin & ~ein[a]);
    }
  }
  return n;
}

// Inside-equality masks after option (a, b): row i becomes row src(i)
// inside the interval (recombination swaps a and b, dosage copies b
// into a), so eq'[i] bit j = eq[src(i)] bit src(j).
template <int MAXP, int KIND>
__device__ __forceinline__ void moved_masks(const uint32_t (&ein)[MAXP], int a, int b,
                                            uint32_t (&out)[MAXP]) {
  const uint32_t ea = pick(ein, a), eb = pick(ein, b);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    uint32_t x = i == a ? eb : (KIND == 0 && i == b) ? ea : ein[i];
    const uint32_t xa = (x >> a) & 1u, xb = (x >> b) & 1u;
    if (KIND == 0) x = (x & ~((1u << a) | (1u << b))) | (xb << a) | (xa << b);
    else x = (x & ~(1u << a)) | (xb << a);
    out[i] = x;
  }
}

// options per pass over reads
template <int MAXP> struct Group { static constexpr int G = MAXP <= 4 ? 12 : 16; };

// One structural MH over the interval [lo, hi) (FULL: every position,
// whose interval sums are the rh rows).  rows0 = rh, interval sums RI(h)
// = rhi[perm[h]]; each MH log ratio is (llk' - llk [+ DM prior ratio]) *
// temp + proposal ratio.
template <int MAXP, int KIND, bool FULL>
__device__ float structural_mh(const Chain& ch, int lo, int hi, bool gate, float u,
                               float llk, float log_p, float temp, int (&perm)[MAXP]) {
  constexpr int G = Group<MAXP>::G;
  constexpr int ROUNDS = (MAXP * (MAXP - 1) + 31) / 32;
  const Params& p = *ch.p;
  const int R = p.R, NB = p.NB, P = ch.P;
  const int K = KIND == 0 ? P * (P - 1) / 2 : P * (P - 1);
  const uint32_t rows = below(P);
  PROF(long long tm = clock64(); constexpr int PB = FULL ? 19 : KIND == 0 ? 9 : 14;)
  uint32_t ein[MAXP], eout[MAXP];
  row_diffs<MAXP>(ch, FULL ? 0 : lo, FULL ? NB : hi, ein, eout);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) { ein[i] = ~ein[i] & rows; eout[i] = ~eout[i] & rows; }
  PROF(MARK(PB))

  // options over lanes: lane k of round q tests option 32 q + k
  const Classes cls = row_classes<MAXP>(ein, eout, P);
  uint32_t vmask[ROUNDS];
  int n_options = 0;
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    bool v = false;
    const int k = 32 * q + ch.lane;
    if (k < K) {
      int a, b;
      option_rows<KIND>(k, P, a, b);
      v = option_valid<MAXP, KIND>(cls, ein, eout, a, b);
    }
    vmask[q] = 32 * q < K ? __ballot_sync(kFull, v) : 0u;
    n_options += __popc(vmask[q]);
  }
  if (!gate || n_options == 0) {
    PROF(MARK(PB + 1))
    return llk;
  }
  const float n_opt1 = fmaxf((float)n_options, 1.f);
  // each lane's option: proposal ratio and, with the prior, its prior change
  float s_cur = 0.f;
  if (ch.prior) {
    uint32_t ef[MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) ef[i] = ein[i] & eout[i];
    s_cur = prior_sum<MAXP>(ef, P, ch.tab);
  }
  float lp_q[ROUNDS], pd_q[ROUNDS];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    lp_q[q] = 0.f;
    pd_q[q] = 0.f;
    if ((vmask[q] >> ch.lane) & 1u) {
      int a, b;
      option_rows<KIND>(32 * q + ch.lane, P, a, b);
      uint32_t en[MAXP];
      moved_masks<MAXP, KIND>(ein, a, b, en);
      const int n_return = count_valid<MAXP, KIND>(en, eout, P);
      lp_q[q] = logf(n_opt1) - logf(fmaxf((float)n_return, 1.f));
      if (ch.prior) {
#pragma unroll
        for (int i = 0; i < MAXP; ++i) en[i] &= eout[i];
        pd_q[q] = __fsub_rn(prior_sum<MAXP>(en, P, ch.tab), s_cur);
      }
    }
  }
  PROF(MARK(PB + 1))

  // valid options in order, G per pass over reads; stop after the pass
  // whose walk chose an option (later options cannot undo the choice)
  float acc = 0.f, chosen_llk = 0.f;
  int chosen = -1;
  uint32_t chosen_desc = 0u;
  int q_cur = 0;
  uint32_t left = vmask[0];
  int done = 0;
#pragma unroll 1
  while (done < n_options && chosen < 0) {
    uint32_t desc[G];  // a | b << 4 | perm[a] << 8 | perm[b] << 12 | k << 16
    int ng = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      desc[g] = 0u;
      if (done + g < n_options) {
        while (left == 0u) left = pick(vmask, ++q_cur);
        const int k = 32 * q_cur + __ffs(left) - 1;
        left &= left - 1u;
        int a, b;
        option_rows<KIND>(k, P, a, b);
        desc[g] = (uint32_t)a | (uint32_t)b << 4 | (uint32_t)pick(perm, a) << 8 |
                  (uint32_t)pick(perm, b) << 12 | (uint32_t)k << 16;
        ng = g + 1;
      }
    }
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.f;
    for (int r = ch.lane; r < R; r += 32) {
      float e[MAXP];
      float m = ch.rh[r];
      for (int h = 1; h < P; ++h) m = fmaxf(m, ch.rh[h * R + r]);
#pragma unroll
      for (int h = 0; h < MAXP; ++h) e[h] = h < P ? expf(ch.rh[h * R + r] - m) : 0.f;
      const float c = __ldg(ch.cnt + r);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= ng) continue;
        const int a = desc[g] & 15, b = (desc[g] >> 4) & 15;
        const int pa = (desc[g] >> 8) & 15, pb = (desc[g] >> 12) & 15;
        // the kept rows' exp(row - m), added in row order
        const uint32_t kept = rows & ~(1u << a) & (KIND == 0 ? ~(1u << b) : ~0u);
        float se = 0.f;
#pragma unroll
        for (int h = 0; h < MAXP; ++h)
          if ((kept >> h) & 1u) se += e[h];
        float cand;
        if (FULL) {
          cand = logf(fmaxf(se + pick(e, b), 1e-30f)) + m;
        } else {
          const float ria = ch.rhi[pa * R + r], rib = ch.rhi[pb * R + r];
          const float row_a = ch.rh[a * R + r] - ria + rib;
          if (KIND == 0) {
            const float rest = logf(fmaxf(se, 1e-30f)) + m;
            const float row_b = ch.rh[b * R + r] - rib + ria;
            cand = logaddexpf_(logaddexpf_(row_a, row_b), rest);
          } else {
            cand = logaddexpf_(row_a, logf(fmaxf(se, 1e-30f)) + m);
          }
        }
        part[g] = __fadd_rn(part[g], __fmul_rn(c, cand - log_p));
      }
    }
    // MH acceptance with the n_options / n_return proposal correction
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) continue;
      const float llk_k = warp_sum(part[g]);
      const int k = desc[g] >> 16;
      const float lp = __shfl_sync(kFull, pick(lp_q, k >> 5), k & 31);
      const float pd = __shfl_sync(kFull, pick(pd_q, k >> 5), k & 31);
      float dl = llk_k - llk;
      if (ch.prior) dl = __fadd_rn(dl, pd);
      const float mh = __fadd_rn(__fmul_rn(dl, temp), lp);
      acc += expf(fminf(0.f, mh)) / n_opt1;
      if (chosen < 0 && acc > u) { chosen = g; chosen_llk = llk_k; }
    }
    if (chosen >= 0) chosen_desc = pick(desc, chosen);
    done += ng;
  }
  PROF(MARK(PB + 2))
  if (chosen < 0 || !(u < acc)) {
    PROF(MARK(PB + 3))
    return llk;
  }
  PROF(MARK(PB + 3))

  // apply: rows copy within the interval
  const int a = chosen_desc & 15, b = (chosen_desc >> 4) & 15;
  const int pa = (chosen_desc >> 8) & 15, pb = (chosen_desc >> 12) & 15;
  __syncwarp();
  const int j0 = FULL ? 0 : lo, j1 = FULL ? NB : hi;
  for (int j = j0 + ch.lane; j < j1; j += 32) {
    const int8_t ga = ch.g[a * NB + j], gb = ch.g[b * NB + j];
    ch.g[a * NB + j] = gb;
    if (KIND == 0) ch.g[b * NB + j] = ga;
  }
  for (int r = ch.lane; r < R; r += 32) {
    if (FULL) {
      ch.rh[a * R + r] = ch.rh[b * R + r];
    } else {
      const float ria = ch.rhi[pa * R + r], rib = ch.rhi[pb * R + r];
      const float ra = ch.rh[a * R + r], rb = ch.rh[b * R + r];
      ch.rh[a * R + r] = ra - ria + rib;
      if (KIND == 0) ch.rh[b * R + r] = rb - rib + ria;
    }
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < MAXP; ++h) {
    if (h == a) perm[h] = pb;
    else if (KIND == 0 && h == b) perm[h] = pa;
  }
  PROF(MARK(PB + 4))
  return chosen_llk;
}

// ---------------------------------------------------------------------------
// the chain
// ---------------------------------------------------------------------------

// Chain c's view of its problem, its warp's aux block and its slots
// (shared memory after the block's aux and swap blocks, or scratch), with
// the log tables filled and the genotype of slot `slot` loaded from g_init.
__device__ Chain load_chain(const Params& p, unsigned char* smem, int warp, int cib,
                            int c, int slot) {
  Chain ch;
  ch.p = &p;
  ch.c = c;
  ch.P = p.P;
  ch.lane = threadIdx.x & 31;
  ch.s = p.problem[c];
  ch.rung_off = 0;
  ch.alpha = 0.f;
  ch.prior = false;
  const int R = p.R, NB = p.NB, A = p.A, T = p.T;
  ch.lr = p.lr + (size_t)ch.s * NB * A * R;
  ch.cnt = p.counts + (size_t)ch.s * R;
  ch.nall = p.nall + (size_t)ch.s * NB;
  float* aux = reinterpret_cast<float*>(smem + (size_t)warp * p.aux_bytes);
  ch.logk = aux;
  ch.loga = aux + kTab;
  ch.tab = aux + 2 * kTab;
  ch.segb = reinterpret_cast<int16_t*>(aux + 3 * kTab);
  const int chains = p.warps / T;
  if (p.in_smem)
    ch.slots = smem + (size_t)p.warps * p.aux_bytes + (size_t)chains * p.swap_bytes +
               (size_t)cib * T * p.slot_bytes;
  else
    ch.slots = p.scratch + (size_t)c * T * p.slot_bytes;
  ch.bind(slot);
  if (ch.lane < kTab) ch.logk[ch.lane] = logf((float)ch.lane);
  for (int i = ch.lane; i < ch.P * NB; i += 32)
    ch.g[i] = (int8_t)p.g_init[(size_t)i * p.C + c];
  __syncwarp();
  return ch;
}

// The T rung-warps of chain `cib` of the block meet here.
__device__ __forceinline__ void chain_barrier(int cib, int T) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + cib), "r"(32 * T) : "memory");
}

// The step's Bernoulli interval partition: a break before position j (1
// <= j < NB) when draw brk0 + j - 1 < pb, segment ids the running count
// of breaks capped at maxseg - 1.  Writes the segment starts to segb
// (segb[n] = NB) and returns the number n of segments.
__device__ int interval_partition(const Chain& ch, int step, int brk0, float pb) {
  const Params& p = *ch.p;
  const int NB = p.NB;
  int count = 0;
  for (int j0 = 0; j0 < NB; j0 += 32) {
    const int j = j0 + ch.lane;
    const bool brk = j >= 1 && j < NB && ch.uni(step, brk0 + j - 1) < pb;
    const uint32_t m = __ballot_sync(kFull, brk);
    const int id = count + __popc(m & (kFull >> (31 - ch.lane)));  // breaks up to j
    if (brk && id <= p.maxseg - 1) ch.segb[id] = (int16_t)j;
    count += __popc(m);
  }
  const int n = min(count, p.maxseg - 1) + 1;
  if (ch.lane == 0) { ch.segb[0] = 0; ch.segb[n] = (int16_t)NB; }
  __syncwarp();
  return n;
}

// K1's chain loop.  LADDER false: one rung at temp 1 and the flat prior,
// known at compile time; true: p.T rungs and, with p.alpha, the prior.
template <int MAXP, bool LADDER>
__device__ __forceinline__ void denovo_chain(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int T = LADDER ? p.T : 1;
  const int rung = warp % T, cib = warp / T;  // rung of chain cib of the block
  const int c = blockIdx.x * (p.warps / T) + cib;
  // the chain's T warps leave together; its barriers are its own
  if (c >= p.C) return;

  Chain ch = load_chain(p, smem, warp, cib, c, rung);
  PROF(if (ch.lane == 0) for (int i = 0; i < K1P_N; ++i) prof_s[warp][i] = 0;)
  const int P = ch.P;
  ch.rung_off = rung * p.Dr;
  const float temp = LADDER ? p.temps[rung] : 1.f;
  if (LADDER && p.alpha) {
    ch.alpha = __ldg(p.alpha + ch.s);
    ch.prior = true;
    if (ch.lane < kTab) ch.loga[ch.lane] = logf(__fadd_rn((float)ch.lane - 1.f, ch.alpha));
    if (ch.lane == 0) prior_table(P, ch.alpha, ch.tab);
    __syncwarp();
  }
  // swap state of chain cib: slot, llk and prior of each rung
  int* sw_slot = reinterpret_cast<int*>(smem + (size_t)p.warps * p.aux_bytes +
                                        (size_t)cib * p.swap_bytes);
  float* sw_llk = reinterpret_cast<float*>(sw_slot + T);
  float* sw_pri = sw_llk + T;
  if (LADDER && T > 1 && ch.lane == 0) sw_slot[rung] = rung;

  const int NB = p.NB, A = p.A;
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
    PROF(long long tm = clock64(); const long long t_step = tm;)
    if (step % p.refresh == 0) {
      row_sums<MAXP>(ch, 0, NB, ch.rh);
      llk = full_llk(ch, log_p);
    }
    PROF(MARK(0))
    llk = mutation_sweep<MAXP>(ch, step, llk, log_p, temp);
    PROF(tm = clock64();)

    if (P > 1) {
      if (p.stage >= 2) {
        const bool gate_r = ch.uni(step, P * NB) <= p.p_recomb;
        const bool gate_d = ch.uni(step, P * NB + 1) <= p.p_partial;
        const int nseg = interval_partition(ch, step, brk0, pb);
        PROF(MARK(7))
#pragma unroll 1
        for (int i = 0; i < nseg; ++i) {
          const int lo = ch.segb[i], hi = ch.segb[i + 1];
          const float u_r = ch.uni(step, seg0 + 2 * i);
          const float u_d = ch.uni(step, seg0 + 2 * i + 1);
          row_sums<MAXP>(ch, lo, hi, ch.rhi);
          int perm[MAXP];
#pragma unroll
          for (int h = 0; h < MAXP; ++h) perm[h] = h;
          PROF(MARK(8))
          llk = structural_mh<MAXP, 0, false>(ch, lo, hi, gate_r, u_r, llk, log_p, temp,
                                              perm);
          PROF(tm = clock64();)
          if (p.stage >= 3)
            llk = structural_mh<MAXP, 1, false>(ch, lo, hi, gate_d, u_d, llk, log_p, temp,
                                                perm);
          PROF(tm = clock64();)
        }
      }
      if (p.stage >= 3) {
        const bool gate_f = ch.uni(step, full0) <= p.p_full;
        int perm[MAXP];
#pragma unroll
        for (int h = 0; h < MAXP; ++h) perm[h] = h;
        llk = structural_mh<MAXP, 1, true>(ch, 0, NB, gate_f, ch.uni(step, full0 + 1), llk,
                                           log_p, temp, perm);
        PROF(tm = clock64();)
      }
    }

    // neighbour swaps from warm to cold (JAX kernel step 4)
    if (LADDER && T > 1) {
      const float pri = ch.prior ? genotype_prior<MAXP>(ch) : 0.f;
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
      ch.bind(sw_slot[rung]);
      PROF(MARK(24))
      if (rung != T - 1) continue;  // only the cold rung writes the trace
    }

    // trace write: base-packed genotype column per position, and llk
    for (int j = ch.lane; j < NB; j += 32) {
      int v = 0, w = 1;
      for (int h = 0; h < P; ++h) { v += ch.g[h * NB + j] * w; w *= basev; }
      const size_t o = ((size_t)step * NB + j) * p.C + c;
      if (p.out_bytes == 1) static_cast<uint8_t*>(p.trace)[o] = (uint8_t)v;
      else if (p.out_bytes == 2) static_cast<int16_t*>(p.trace)[o] = (int16_t)v;
      else static_cast<int32_t*>(p.trace)[o] = v;
    }
    if (ch.lane == 0) p.llks[(size_t)step * p.C + c] = llk;
    PROF(MARK(25) PROF_ADD(30, clock64() - t_step))
  }
  PROF(if (ch.lane == 0) for (int i = 0; i < K1P_N; ++i) atomicAdd(&g_prof[i], prof_s[warp][i]);)
}

#ifndef K1_LADDER
// the flat single-rung chain
template <int MAXP>
__global__ void __launch_bounds__(128) denovo_kernel(Params p) {
  denovo_chain<MAXP, false>(p);
}
#else
// 1-8 rungs and the optional prior; one resident block per SM lets ptxas
// give the larger instances their registers
template <int MAXP>
__global__ void __launch_bounds__(256, 1) denovo_ladder_kernel(Params p) {
  denovo_chain<MAXP, true>(p);
}
#endif

// shared memory of a block of warps / T chains
size_t block_smem(const Params& p) {
  const int chains = p.warps / p.T;
  return (size_t)p.warps * p.aux_bytes + (size_t)chains * p.swap_bytes +
         (p.in_smem ? (size_t)chains * p.T * p.slot_bytes : 0);
}

void set_layout(Params& p) {
  const Layout l = state_layout(p.P, p.R, p.NB, p.T);
  p.slot_bytes = l.slot;
  p.aux_bytes = l.aux;
  p.swap_bytes = l.swap;
  p.in_smem = l.in_smem;
}

template <int MAXP>
cudaError_t launch_k1(const Params& p, cudaStream_t stream) {
  const int chains = p.warps / p.T;
  const size_t smem = block_smem(p);
  const int blocks = (p.C + chains - 1) / chains;
#ifdef K1_LADDER
  cudaError_t err = cudaFuncSetAttribute(
      denovo_ladder_kernel<MAXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  denovo_ladder_kernel<MAXP><<<blocks, 32 * p.warps, smem, stream>>>(p);
#else
  if (p.T > 1 || p.alpha != nullptr) return cudaErrorInvalidValue;  // the ladder build's
  cudaError_t err = cudaFuncSetAttribute(
      denovo_kernel<MAXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  denovo_kernel<MAXP><<<blocks, 32 * p.warps, smem, stream>>>(p);
#endif
  return cudaGetLastError();
}

#ifndef K1_LADDER

// K0: one mutation sweep at inverse temperature temp from a given llk
// (replaces mchap_tpu/ops/pallas_denovo.py::pallas_mutation_sweep, body
// _make_kernel).  rh is rebuilt from the genotype, the sweep is K1's, and
// the genotype, rh and llk are written out.
template <int MAXP>
__global__ void __launch_bounds__(128) mutation_kernel(Params p, const float* llk_in,
                                                       float temp, int* g_out,
                                                       float* rh_out, float* llk_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * p.warps + warp;
  if (c >= p.C) return;

  const Chain ch = load_chain(p, smem, warp, warp, c, 0);
  const int R = p.R, NB = p.NB, P = ch.P;
  row_sums<MAXP>(ch, 0, NB, ch.rh);
  const float llk = mutation_sweep<MAXP>(ch, 0, llk_in[c], logf((float)P), temp);
  __syncwarp();
  for (int i = ch.lane; i < P * NB; i += 32) g_out[(size_t)i * p.C + c] = ch.g[i];
  for (int i = ch.lane; i < P * R; i += 32) rh_out[(size_t)i * p.C + c] = ch.rh[i];
  if (ch.lane == 0) llk_out[c] = llk;
}

template <int MAXP>
cudaError_t launch_mutation(const Params& p, const float* llk_in, float temp, int* g_out,
                            float* rh_out, float* llk_out, cudaStream_t stream) {
  const size_t smem = block_smem(p);
  cudaError_t err = cudaFuncSetAttribute(
      mutation_kernel<MAXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.C + p.warps - 1) / p.warps;
  mutation_kernel<MAXP><<<blocks, 32 * p.warps, smem, stream>>>(p, llk_in, temp, g_out,
                                                                 rh_out, llk_out);
  return cudaGetLastError();
}
#endif  // K1_LADDER

}  // namespace

extern "C" {

// Where one chain of T rungs keeps its state (T = 1 for K0): returns 1
// when its slots are in shared memory, 0 when in scratch, and writes the
// shared-memory and scratch bytes per chain.  The launches use the same
// layout; blocks hold warps / T chains.
int denovo_sampler_state_layout(int P, int R, int NB, int T, int64_t* smem_bytes,
                                int64_t* scratch_bytes) {
  const Layout l = state_layout(P, R, NB, T);
  *smem_bytes = l.smem_chain;
  *scratch_bytes = l.scratch_chain;
  return l.in_smem;
}

const char* denovo_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 entry: alpha [S] or null; temps is a host array of T floats; warps
// per block is a multiple of T; scratch holds C chains' scratch bytes
// (denovo_sampler_state_layout) or is null when the slots fit shared
// memory.
int denovo_sampler_launch(const void* lr, const void* counts, const void* nall,
                          const void* pbreak, const void* alpha, const void* problem,
                          const void* g_init, const void* noise, void* trace, void* llks,
                          void* scratch, int S, int R, int NB, int A, int P, int C,
                          int n_steps, int T, const float* temps, float p_recomb,
                          float p_partial, float p_full, int refresh, int stage,
                          int out_bytes, uint64_t seed, uint32_t chain_offset, int warps,
                          void* stream) {
  if (T < 1 || T > kMaxTemps || warps % T != 0 || (T > 1 && warps / T > 15) || P < 1 ||
      P > kMaxPloidy)
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
  p.scratch = static_cast<unsigned char*>(scratch);
  p.S = S; p.R = R; p.NB = NB; p.A = A; p.C = C; p.n_steps = n_steps; p.P = P;
  p.p_recomb = p_recomb; p.p_partial = p_partial; p.p_full = p_full;
  p.refresh = refresh; p.stage = stage; p.out_bytes = out_bytes;
  p.seed = seed;
  p.chain_offset = chain_offset;
  p.warps = warps;
  p.T = T;
  for (int t = 0; t < T; ++t) p.temps[t] = temps[t];
  p.maxseg = NB / 4 + 2 < NB ? NB / 4 + 2 : NB;
  if (p.maxseg < 2) p.maxseg = 2;
  p.Dr = P * NB + 2 + (NB - 1) + 2 * p.maxseg + 2;
  p.D = T * p.Dr + T - 1;
  set_layout(p);
  if (!p.in_smem && !scratch) return cudaErrorInvalidValue;
  if (C == 0 || n_steps == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 4) return launch_k1<4>(p, s);
  if (P <= 8) return launch_k1<8>(p, s);
  return launch_k1<12>(p, s);
}

#ifndef K1_LADDER
// K0 entry: lr [S][NB][A][R], counts [S][R], nall [S][NB], problem [C],
// g_init [P][NB][C], llk_in [C], noise [P*NB][C] or null, scratch as for
// K1 with T = 1; writes g_out [P][NB][C], rh_out [P][R][C] and llk_out [C].
int mutation_sweep_launch(const void* lr, const void* counts, const void* nall,
                          const void* problem, const void* g_init, const void* noise,
                          const void* llk_in, void* g_out, void* rh_out, void* llk_out,
                          void* scratch, int S, int R, int NB, int A, int P, int C,
                          float temp, uint64_t seed, int warps, void* stream) {
  if (P < 1 || P > 8) return cudaErrorInvalidValue;
  Params p = {};
  p.lr = static_cast<const float*>(lr);
  p.counts = static_cast<const float*>(counts);
  p.nall = static_cast<const int*>(nall);
  p.problem = static_cast<const int*>(problem);
  p.g_init = static_cast<const int*>(g_init);
  p.noise = static_cast<const float*>(noise);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.S = S; p.R = R; p.NB = NB; p.A = A; p.C = C; p.n_steps = 1; p.P = P;
  p.seed = seed;
  p.warps = warps;
  p.T = 1;
  p.temps[0] = 1.f;
  p.Dr = p.D = P * NB;  // the sweep's draws: site (h, j) -> h * NB + j
  set_layout(p);
  if (!p.in_smem && !scratch) return cudaErrorInvalidValue;
  if (C == 0) return cudaSuccess;
  const float* li = static_cast<const float*>(llk_in);
  int* go = static_cast<int*>(g_out);
  float* ro = static_cast<float*>(rh_out);
  float* lo = static_cast<float*>(llk_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 4) return launch_mutation<4>(p, li, temp, go, ro, lo, s);
  return launch_mutation<8>(p, li, temp, go, ro, lo, s);
}

#endif  // K1_LADDER

}  // extern "C"
