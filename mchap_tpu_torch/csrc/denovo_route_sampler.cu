// K4: the XLA de novo sampler's compound step for Hopper (sm_90a), in f64.
//
// Replaces the jitted XLA program mchap_tpu/ops/assemble_mcmc.py::
// denovo_sampler (jit :481; the site scan :293, the interval scan :432,
// the step scan :607), the route mchap_tpu takes for the assemble blocks
// its Pallas kernel refuses: a Dirichlet-multinomial prior where some
// sample has inbreeding 0, more than 8 tempering rungs, ploidy above 12,
// or a fixed interval count.  The plain version is mchap_tpu_torch/ops/
// assemble_mcmc.py::denovo_sampler; this kernel computes the same Markov
// chain on the same keyed draws, each step's sub-steps in run_step's
// order:
//
// 1. a mutation sweep over the row's P x NB sites in the order of the
//    ranks of the step's first P * NB draws (stable argsort), each site
//    an MH-within-Gibbs choice over the A alleles with the haplotype-copy
//    proposal ratio;
// 2. the recombination sweep and 3. the partial-dosage sweep, each over
//    an interval partition drawn from break_dist and visited in a drawn
//    order, one enumeration MH step per non-empty interval over the
//    C(P, 2) recombination or P (P - 1) dosage options;
// 4. the full-length dosage step;
// 5. with T > 1 rungs, neighbour swaps warmest pair first (swap_kernel).
//
// Every draw is utils/philox.keyed_uniforms(seed, row, step, D, f64): key
// (seed & 0xFFFFFFFF, row_offset + row), counter (step, j >> 1, seed >> 32,
// 0), words 2 (j & 1) and 2 (j & 1) + 1.  row_offset is the call's first
// row in the whole block, so a block split over launches, cards or ranks
// draws what one launch draws.  All arithmetic is f64 with the plain
// version's operations in its order; what differs is the order of the sums
// over reads (a lane's reads in turn, then a butterfly), so llks agree to
// rounding and the choices agree.  Products that the plain version rounds
// before adding are written with __dmul_rn / __dadd_rn so nvcc does not
// contract them into an FMA.  The prior's per-dosage terms, log k and the
// row constants come from the wrapper, computed by the same torch
// functions the plain version calls.
//
// Layout: one warp per row (a chain-rung), reads over the lanes (r = lane,
// lane + 32, ...); each sum over reads is a 5-step xor butterfly, so every
// lane holds the bitwise-same total and takes the same decision.  Work on
// rows of the genotype (row equality, labels, option counts) is spread over
// lanes by row or by option.  A row's state (genotype int8[P][NB], rh
// f64[P][R], llk) lives in a slot in device memory; rows point at slots, so
// a swap exchanges two slot indices.  A row's workspace (its draws, interval
// sums rh_int f64[P][R], the options' llks, priors and counts) is device
// memory too: nothing is sized by shared memory, so any ploidy up to 64 and
// any read depth the card holds runs; the wrapper splits the rows into
// pieces of whole chains when one piece's memory would not fit.
//
// Launches: init_kernel once (slots from the initial genotypes, rh and
// llk), then per step step_kernel over all rows and, with T > 1,
// swap_kernel over chains (one thread each).  The cold rung's trace of a
// kept step is written by the last launch of that step.
//
// What bounds it on this card: each row is a long chain of dependent
// decisions, each waiting on a warp sum over reads of f64 exp/log terms
// (P terms per read and option in the structural steps).  The f64
// exp/log instruction sequences bound the work at large ploidy; at the
// shapes of the assemble route (P4, a few hundred rows) the latency of the
// dependent chain does, with the card mostly idle.  A faster design (rows'
// state in shared memory, options over lanes) is later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // rows (warps) per block of the step kernels
constexpr int kMaxP = 64;      // row-equality sets are 64-bit masks
constexpr int kMaxA = 8;       // a lane's per-allele partial sums
constexpr double kNeg = -1e300;

struct Params {
  const double* lr;      // [S][NB][R][A] log P(read | allele)
  const double* counts;  // [S][R]
  const int* nall;       // [S][NB]; 1 marks a fixed position
  const double* bdist;   // [S][NB] distribution of the break count
  const double* log_uh;  // [S]
  const double* inbr;    // [S] inbreeding, or null: no prior
  const double* ptab;    // [S][P + 1] the prior's term of a row group of dosage d
  const double* pconst;  // [S] the prior's constant
  const double* logk;    // log(k), k = 0 .. n_log - 1
  const double* temps;   // [T] inverse temperatures, ascending
  const int8_t* init;    // [S][C][P][NB]
  int8_t* trace_g;       // [kept][S * C][P][NB]
  double* trace_llk;     // [kept][S * C]
  int8_t* g;             // slots: [rows][P][NB]
  double* rh;            // slots: [rows][P][R]
  double* llk;           // slots: [rows]
  int* slot;             // [rows] the slot of each row
  double* u;             // workspace: [rows][D] the step's draws
  double* rh_int;        // workspace: [rows][P][R] interval sums
  double* opt;           // workspace: [rows][2 K] options' llks, then priors
  int* wi;               // workspace: [rows][n_wi]
  int S, C, T, P, NB, R, A;
  int K;                 // P (P - 1): the larger option table
  int D, n_wi;
  int row0, rows;        // this launch's rows: [row0, row0 + rows) of the call
  int step, burn;
  double log_p, p_recomb, p_partial, p_full;
  uint64_t seed;
  uint64_t row_offset;   // the call's row 0 in the whole block
  int off_sites, off_recomb, off_partial, off_full, off_swap;
};

// per-row counts of the workspace, and the step's draw layout
// (assemble_mcmc.step_draw_offsets)
void sizes(int P, int NB, int64_t* n_wi, int64_t* n_opt, int64_t* D, int* offs) {
  const int sites = P * NB;
  const int structural = 3 * NB + 1;
  offs[0] = sites;                       // the sites' draws
  offs[1] = 2 * sites;                   // recombination sweep
  offs[2] = offs[1] + structural;        // partial-dosage sweep
  offs[3] = offs[2] + structural;        // full dosage step: gate, draw
  offs[4] = offs[3] + 2;                 // swap
  *D = offs[4] + 1;
  const int64_t K = (int64_t)P * (P - 1);
  *n_wi = sites + 3 * (int64_t)NB + 2 * K;
  *n_opt = 2 * K;
}

struct Row {
  int n, t, s;           // chain (in the call), rung, problem
  int8_t* g;
  double* rh;
  double* llk;
  double* u;
  double* rh_int;
  double* opt_llk;
  double* opt_prior;
  int* order;            // [P NB] sites in visiting order
  int* rank_pt;          // [NB] ranks of the break-point draws
  int* cuts;             // [NB] the chosen break points ascending, padded with NB
  int* iorder;           // [NB] intervals in visiting order
  int* opt_valid;        // [K]
  int* opt_nret;         // [K]
  const double* lr;
  const double* cnt;
  const int* nall;
  const double* ptab;
  double temp, pconst, log_uh;
  bool prior, flat;
};

__device__ __forceinline__ void philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t k0,
                                       uint32_t k1, uint32_t* w) {
  uint32_t c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = c0 * 0xD2511F53u, hi0 = __umulhi(c0, 0xD2511F53u);
    const uint32_t lo1 = c2 * 0xCD9E8D57u, hi1 = __umulhi(c2, 0xCD9E8D57u);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  w[0] = c0; w[1] = c1; w[2] = c2; w[3] = c3;
}

// utils/philox.uniform_f64: 21 bits of w0 above the 32 of w1, over 2**53
__device__ __forceinline__ double uniform_f64(uint32_t w0, uint32_t w1) {
  const uint64_t x = ((uint64_t)(w0 >> 11) << 32) | w1;
  const double v = (double)x * 0x1p-53;
  return v < 0x1p-54 ? 0x1p-54 : v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// torch.logaddexp
__device__ __forceinline__ double logaddexp(double a, double b) {
  if (isinf(a) && a == b) return a;
  const double m = a > b ? a : b;
  return m + log1p(exp(-fabs(a - b)));
}

// rank of x[i] among x[0..n), ties by index (torch.argsort(stable=True))
__device__ int rank_of(const double* x, int n, int i) {
  const double v = x[i];
  int r = 0;
  for (int k = 0; k < n; ++k) {
    const double y = x[k];
    r += (y < v) || (y == v && k < i);
  }
  return r;
}

// the prior's value from the sum of its per-group terms
__device__ __forceinline__ double prior_value(const Row& w, int P, double sum) {
  return w.flat ? __dsub_rn(__dsub_rn(w.pconst, sum), __dmul_rn((double)P, w.log_uh))
                : __dadd_rn(w.pconst, sum);
}

// log prior of the genotype whose row-equality masks are eq[0..P) (bit q of
// eq[a]: rows a and q are equal), with row and column h replaced by eqh
// when h >= 0 (assemble_mcmc._genotype_prior_from_eq)
__device__ double eq_prior(const Row& w, const uint64_t* eq, int P, int h, uint64_t eqh) {
  double sum = 0.0;
  for (int a = 0; a < P; ++a) {
    uint64_t m = eq[a];
    if (h >= 0) m = a == h ? eqh : (m & ~(1ull << h)) | (((eqh >> a) & 1ull) << h);
    const bool first = (m & ((1ull << a) - 1ull)) == 0;
    sum += w.ptab[first ? __popcll(m) : 0];
  }
  return prior_value(w, P, sum);
}

// log prior of a genotype whose rows a and b are equal iff in[a] == in[b]
// and out[a] == out[b] (segment labels inside and outside an interval)
__device__ double labels_prior(const Row& w, const int8_t* in, const int8_t* out, int P) {
  double sum = 0.0;
  for (int a = 0; a < P; ++a) {
    bool first = true;
    int c = 0;
    for (int b = 0; b < P; ++b) {
      const bool e = in[a] == in[b] && out[a] == out[b];
      c += e;
      first &= !(b < a && e);
    }
    sum += w.ptab[first ? c : 0];
  }
  return prior_value(w, P, sum);
}

// log prior of genotype g [P][NB] (one thread)
__device__ double genotype_prior(const Row& w, const int8_t* g, int P, int NB) {
  double sum = 0.0;
  for (int a = 0; a < P; ++a) {
    bool first = true;
    int c = 0;
    for (int b = 0; b < P; ++b) {
      bool e = true;
      for (int k = 0; k < NB && e; ++k) e = g[a * NB + k] == g[b * NB + k];
      c += e;
      first &= !(b < a && e);
    }
    sum += w.ptab[first ? c : 0];
  }
  return prior_value(w, P, sum);
}

// for segment labels (in, out): rows first of their full group, first of
// their inside group, and alone inside
__device__ void label_masks(const int8_t* in, const int8_t* out, int P, uint64_t& ffirst,
                            uint64_t& ifirst, uint64_t& ione) {
  ffirst = ifirst = ione = 0;
  for (int a = 0; a < P; ++a) {
    bool ff = true, fi = true;
    int ci = 0;
    for (int b = 0; b < P; ++b) {
      const bool ei = in[a] == in[b];
      ci += ei;
      if (b < a && ei) {
        fi = false;
        if (out[a] == out[b]) ff = false;
      }
    }
    ffirst |= (uint64_t)ff << a;
    ifirst |= (uint64_t)fi << a;
    ione |= (uint64_t)(ci == 1) << a;
  }
}

// option (h0, h1) of table `type` is valid for labels with these masks
// (assemble_mcmc._recombination_pairs, _dosage_pairs)
__device__ __forceinline__ bool pair_valid(int type, int h0, int h1, const int8_t* in,
                                           const int8_t* out, uint64_t ffirst, uint64_t ifirst,
                                           uint64_t ione) {
  if (type == 0)
    return ((ffirst >> h0) & 1) && ((ffirst >> h1) & 1) && in[h0] != in[h1] && out[h0] != out[h1];
  return ((ffirst >> h0) & 1) && !((ione >> h0) & 1) && ((ifirst >> h1) & 1) && in[h0] != in[h1];
}

// count of valid options of table `type` for labels (in, out)
// (recombination_n_options, dosage_n_options)
__device__ int count_options(int type, const int8_t* in, const int8_t* out, int P) {
  uint64_t ff, fi, one;
  label_masks(in, out, P, ff, fi, one);
  int n = 0;
  for (int a = 0; a < P; ++a)
    for (int b = type == 0 ? a + 1 : 0; b < P; ++b)
      n += a != b && pair_valid(type, a, b, in, out, ff, fi, one);
  return n;
}

// option k of table `type`: itertools.combinations (recombination, h0 <
// h1) or itertools.permutations (dosage, h0 != h1) order
__device__ __forceinline__ void decode(int type, int P, int k, int& h0, int& h1) {
  if (type == 0) {
    h0 = 0;
    while (k >= P - 1 - h0) { k -= P - 1 - h0; ++h0; }
    h1 = h0 + 1 + k;
  } else {
    h0 = k / (P - 1);
    const int r = k % (P - 1);
    h1 = r < h0 ? r : r + 1;
  }
}

// the row each row's segment comes from under option (h0, h1); h0 < 0:
// no move
__device__ __forceinline__ int src_of(int type, int h0, int h1, int q) {
  return q == h0 ? h1 : (type == 0 && q == h1 ? h0 : q);
}

__device__ Row bind(const Params& p, int b) {
  Row w;
  const int gb = p.row0 + b;
  w.n = gb / p.T;
  w.t = gb % p.T;
  w.s = w.n / p.C;
  const int P = p.P, NB = p.NB, R = p.R, K = p.K;
  const int sl = p.slot[b];
  w.g = p.g + (size_t)sl * P * NB;
  w.rh = p.rh + (size_t)sl * P * R;
  w.llk = p.llk + sl;
  w.u = p.u + (size_t)b * p.D;
  w.rh_int = p.rh_int + (size_t)b * P * R;
  w.opt_llk = p.opt + (size_t)b * 2 * K;
  w.opt_prior = w.opt_llk + K;
  int* wi = p.wi + (size_t)b * p.n_wi;
  w.order = wi;
  w.rank_pt = w.order + P * NB;
  w.cuts = w.rank_pt + NB;
  w.iorder = w.cuts + NB;
  w.opt_valid = w.iorder + NB;
  w.opt_nret = w.opt_valid + K;
  w.lr = p.lr + (size_t)w.s * NB * R * p.A;
  w.cnt = p.counts + (size_t)w.s * R;
  w.nall = p.nall + (size_t)w.s * NB;
  w.temp = p.temps[w.t];
  w.log_uh = p.log_uh[w.s];
  w.prior = p.inbr != nullptr;
  w.flat = w.prior && p.inbr[w.s] == 0.0;
  w.ptab = w.prior ? p.ptab + (size_t)w.s * (P + 1) : nullptr;
  w.pconst = w.prior ? p.pconst[w.s] : 0.0;
  return w;
}

// ---------------------------------------------------------------------------
// mutation compound step (assemble_mcmc.mutation_sweep, one site)
// ---------------------------------------------------------------------------

__device__ double site_step(const Params& p, const Row& w, double llk, int h, int j, double u,
                            int lane, uint64_t* eq) {
  const int P = p.P, NB = p.NB, R = p.R, A = p.A;
  int8_t* g = w.g;
  const int cur = g[h * NB + j];
  const double* lrj = w.lr + (size_t)j * R * A;

  // each candidate allele's llk: a lane's reads in turn, then the butterfly
  double part[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) part[a] = 0.0;
  for (int r = lane; r < R; r += 32) {
    const double* l = lrj + (size_t)r * A;
    const double* x = w.rh + r;
    const double base = x[(size_t)h * R] - l[cur];
    double rest = kNeg;  // logsumexp of the other rows (none: the mask value)
    if (P > 1) {
      double m = kNeg;
      for (int q = 0; q < P; ++q)
        if (q != h) m = fmax(m, x[(size_t)q * R]);
      double s = 0.0;
      for (int q = 0; q < P; ++q)
        if (q != h) s += exp(x[(size_t)q * R] - m);
      rest = log(s) + m;
    }
    const double c = w.cnt[r];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a)
      if (a < A) part[a] = __dadd_rn(part[a], __dmul_rn(c, logaddexp(rest, base + l[a]) - p.log_p));
  }
  double llks[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) llks[a] = a < A ? warp_sum(part[a]) : 0.0;

  // rows other than h equal to h outside j
  uint64_t same = 0;
  for (int q0 = 0; q0 < P; q0 += 32) {
    const int q = q0 + lane;
    bool e = q < P && q != h;
    for (int k = 0; k < NB && e; ++k) e = k == j || g[q * NB + k] == g[h * NB + k];
    same |= (uint64_t)__ballot_sync(kFull, e) << q0;
  }
  // proposal ratio from haplotype copy counts
  int count_cur = 1;
  int cnt_a[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) cnt_a[a] = 1;
  uint64_t col_a[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) col_a[a] = 0;
  for (int q = 0; q < P; ++q) {
    const int v = g[q * NB + j];
    const bool sq = (same >> q) & 1;
    count_cur += sq && v == cur;
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      cnt_a[a] += sq && v == a;
      col_a[a] |= (uint64_t)(v == a) << q;
    }
  }

  const int n_j = w.nall[j];
  int n_valid = 0;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) n_valid += a < A && a < n_j && a != cur && n_j > 1;

  double dprior[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) dprior[a] = 0.0;
  if (w.prior) {
    for (int q = lane; q < P; q += 32) {
      uint64_t m = 0;
      for (int b = 0; b < P; ++b) {
        bool e = true;
        for (int k = 0; k < NB && e; ++k) e = g[q * NB + k] == g[b * NB + k];
        m |= (uint64_t)e << b;
      }
      eq[q] = m;
    }
    __syncwarp();
    const double lp = eq_prior(w, eq, P, -1, 0);
#pragma unroll
    for (int a = 0; a < kMaxA; ++a)
      if (a < A && a < n_j && a != cur && n_j > 1)
        dprior[a] = eq_prior(w, eq, P, h, (same & col_a[a]) | (1ull << h)) - lp;
  }

  // acceptance and the inverse-cdf choice (staying at cur takes the rest)
  const double log_n = p.logk[n_valid > 1 ? n_valid : 1];
  double probs[kMaxA];
  double total = 0.0;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    probs[a] = 0.0;
    if (a < A && a < n_j && a != cur && n_j > 1) {
      double score = llks[a] - llk;
      if (w.prior) score = score + dprior[a];
      const double lratio = p.logk[cnt_a[a]] - p.logk[count_cur];
      const double mh = __dadd_rn(__dmul_rn(score, w.temp), lratio);
      probs[a] = exp((mh > 0.0 ? 0.0 : mh) - log_n);
    }
    if (a < A) total += probs[a];
  }
  const double stay = 1.0 - total;
  double cdf = 0.0;
  int choice = 0;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a)
    if (a < A) {
      cdf += a == cur ? stay : probs[a];
      choice += cdf <= u;
    }
  if (choice > A - 1) choice = A - 1;
  double llk_new = llks[0];
#pragma unroll
  for (int a = 1; a < kMaxA; ++a)
    if (a == choice) llk_new = llks[a];

  __syncwarp();  // every lane has read g (and eq)
  if (lane == 0) g[h * NB + j] = (int8_t)choice;
  for (int r = lane; r < R; r += 32) {
    const double* l = lrj + (size_t)r * A;
    double* x = w.rh + (size_t)h * R + r;
    const double base = *x - l[cur];
    *x = base + l[choice];
  }
  __syncwarp();
  return llk_new;
}

// ---------------------------------------------------------------------------
// structural compound step (assemble_mcmc.interval_step, structural_sweep)
// ---------------------------------------------------------------------------

// llk of option (h0, h1) of table `type`: each read's logsumexp over the
// rows of rh_out + the moved interval sums
__device__ double option_llk(const Params& p, const Row& w, int type, int h0, int h1,
                             int lane) {
  const int P = p.P, R = p.R;
  double acc = 0.0;
  for (int r = lane; r < R; r += 32) {
    const double* x = w.rh + r;
    const double* y = w.rh_int + r;
    double m = -INFINITY;
    for (int q = 0; q < P; ++q) {
      const double v = (x[(size_t)q * R] - y[(size_t)q * R]) + y[(size_t)src_of(type, h0, h1, q) * R];
      m = fmax(m, v);
    }
    double s = 0.0;
    for (int q = 0; q < P; ++q) {
      const double v = (x[(size_t)q * R] - y[(size_t)q * R]) + y[(size_t)src_of(type, h0, h1, q) * R];
      s += exp(v - m);
    }
    acc = __dadd_rn(acc, __dmul_rn((log(s) + m) - p.log_p, w.cnt[r]));
  }
  return warp_sum(acc);
}

// acceptance probability of option k (0 when invalid)
__device__ __forceinline__ double option_prob(const Params& p, const Row& w, int k, double llk,
                                              double lp, double log_n) {
  if (!w.opt_valid[k]) return 0.0;
  double score = w.opt_llk[k] - llk;
  if (w.prior) score = score + (w.opt_prior[k] - lp);
  const int nr = w.opt_nret[k];
  const double lproposal = log_n - p.logk[nr > 1 ? nr : 1];
  const double mh = __dadd_rn(__dmul_rn(score, w.temp), lproposal);
  return exp((mh > 0.0 ? 0.0 : mh) - log_n);
}

// one enumeration MH step on positions [st, en) of every row
__device__ double interval_step(const Params& p, const Row& w, double llk, int st, int en,
                                int type, double u, int lane, int8_t* s_in, int8_t* s_out) {
  const int P = p.P, NB = p.NB, R = p.R, A = p.A;
  const int K = type == 0 ? P * (P - 1) / 2 : P * (P - 1);
  int8_t* g = w.g;

  // segment labels: the first row equal inside, and outside, the interval
  for (int q = lane; q < P; q += 32) {
    int li = q, lo = q;
    for (int b = q - 1; b >= 0; --b) {
      bool ein = true, eout = true;
      for (int k = 0; k < NB; ++k) {
        const bool e = g[b * NB + k] == g[q * NB + k];
        if (k >= st && k < en) ein &= e; else eout &= e;
      }
      if (ein) li = b;
      if (eout) lo = b;
    }
    s_in[q] = (int8_t)li;
    s_out[q] = (int8_t)lo;
  }
  // interval sums of the current genotype, a lane's own reads
  for (int r = lane; r < R; r += 32)
    for (int q = 0; q < P; ++q) {
      double s = 0.0;
      for (int k = st; k < en; ++k) s += w.lr[((size_t)k * R + r) * A + g[q * NB + k]];
      w.rh_int[(size_t)q * R + r] = s;
    }
  __syncwarp();

  int8_t in[kMaxP], out[kMaxP], opt_in[kMaxP];
  for (int q = 0; q < P; ++q) {
    in[q] = s_in[q];
    out[q] = s_out[q];
  }
  uint64_t ff, fi, one;
  label_masks(in, out, P, ff, fi, one);
  const double lp = w.prior ? labels_prior(w, in, out, P) : 0.0;
  // options over lanes: validity, reverse-move counts, priors
  int n_valid = 0;
  for (int k = lane; k < K; k += 32) {
    int h0, h1;
    decode(type, P, k, h0, h1);
    const bool valid = pair_valid(type, h0, h1, in, out, ff, fi, one);
    int nret = 0;
    double pr = 0.0;
    if (valid) {
      for (int q = 0; q < P; ++q) opt_in[q] = in[src_of(type, h0, h1, q)];
      nret = count_options(type, opt_in, out, P);
      if (w.prior) pr = labels_prior(w, opt_in, out, P);
    }
    w.opt_valid[k] = valid;
    w.opt_nret[k] = nret;
    w.opt_prior[k] = pr;
    n_valid += valid;
  }
  n_valid = __reduce_add_sync(kFull, n_valid);
  __syncwarp();

  // valid options' llks (an invalid option's probability is 0)
  for (int k = 0; k < K; ++k) {
    if (!w.opt_valid[k]) continue;
    int h0, h1;
    decode(type, P, k, h0, h1);
    const double v = option_llk(p, w, type, h0, h1, lane);
    if (lane == 0) w.opt_llk[k] = v;
  }
  __syncwarp();

  const double log_n = p.logk[n_valid > 1 ? n_valid : 1];
  double total = 0.0;
  for (int k = 0; k < K; ++k) total += option_prob(p, w, k, llk, lp, log_n);
  double cdf = 0.0;
  int choice = 0;
  for (int k = 0; k < K; ++k) {
    cdf += option_prob(p, w, k, llk, lp, log_n);
    choice += cdf <= u;
  }
  cdf += 1.0 - total;  // staying
  choice += cdf <= u;
  if (choice > K) choice = K;

  int h0 = -1, h1 = -1;  // no move
  double llk_new = llk;
  if (choice < K) {
    decode(type, P, choice, h0, h1);
    llk_new = w.opt_valid[choice] ? w.opt_llk[choice] : option_llk(p, w, type, h0, h1, lane);
  }
  __syncwarp();  // every lane has read g and the options
  if (h0 >= 0 && lane == 0)
    for (int k = st; k < en; ++k) {
      const int8_t a = g[h0 * NB + k], b = g[h1 * NB + k];
      g[h0 * NB + k] = b;
      if (type == 0) g[h1 * NB + k] = a;
    }
  // rh = rh_out + the interval sums of each row's source
  for (int r = lane; r < R; r += 32)
    for (int q = 0; q < P; ++q) {
      double* x = w.rh + (size_t)q * R + r;
      const double* y = w.rh_int + r;
      *x = (*x - y[(size_t)q * R]) + y[(size_t)src_of(type, h0, h1, q) * R];
    }
  __syncwarp();
  return llk_new;
}

// interval steps over the partition drawn from u[0 .. 3 NB]: gate, break
// count, NB - 1 break-point draws, NB order draws, NB step draws
__device__ double structural_sweep(const Params& p, const Row& w, double llk, const double* u,
                                   double p_do, int type, int lane, int8_t* s_in,
                                   int8_t* s_out) {
  if (!(u[0] <= p_do)) return llk;  // skipped: every interval empty, no change
  const int NB = p.NB;
  const double* bd = p.bdist + (size_t)w.s * NB;
  int n_breaks = 0;
  double cdf = 0.0;
  for (int k = 0; k < NB; ++k) {
    cdf += bd[k];
    n_breaks += cdf <= u[1];
  }
  for (int i = lane; i < NB - 1; i += 32) w.rank_pt[i] = rank_of(u + 2, NB - 1, i);
  for (int i = lane; i < NB; i += 32) w.iorder[rank_of(u + 1 + NB, NB, i)] = i;
  __syncwarp();
  if (lane == 0) {
    // break point i + 1 is chosen when its draw ranks below n_breaks
    int c = 0;
    for (int v = 1; v < NB; ++v)
      if (w.rank_pt[v - 1] < n_breaks) w.cuts[c++] = v;
    for (; c < NB - 1; ++c) w.cuts[c] = NB;
  }
  __syncwarp();
  for (int i = 0; i < NB; ++i) {
    const int q = w.iorder[i];
    const int st = q == 0 ? 0 : w.cuts[q - 1];
    const int en = q < NB - 1 ? w.cuts[q] : NB;
    if (st < en) llk = interval_step(p, w, llk, st, en, type, u[2 * NB + 1 + i], lane, s_in, s_out);
  }
  __syncwarp();  // every lane has read the partition
  return llk;
}

__device__ void write_trace(const Params& p, int n, const int8_t* g, double llk, int lane,
                            int lanes) {
  const size_t kept = (size_t)(p.step - p.burn);
  const size_t N = (size_t)p.S * p.C;
  const int PN = p.P * p.NB;
  int8_t* tg = p.trace_g + (kept * N + n) * PN;
  for (int i = lane; i < PN; i += lanes) tg[i] = g[i];
  if (lane == 0) p.trace_llk[kept * N + n] = llk;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// slots from the initial genotypes; rh and llk (assemble_mcmc.initial_state)
__global__ void __launch_bounds__(32 * kWarps) init_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.rows) return;
  if (lane == 0) p.slot[b] = b;
  __syncwarp();
  const Row w = bind(p, b);
  const int P = p.P, NB = p.NB, R = p.R, A = p.A;
  const int8_t* g0 = p.init + ((size_t)w.s * p.C + w.n % p.C) * P * NB;
  for (int i = lane; i < P * NB; i += 32) w.g[i] = g0[i];
  __syncwarp();
  double acc = 0.0;
  for (int r = lane; r < R; r += 32) {
    double m = -INFINITY;
    for (int q = 0; q < P; ++q) {
      double s = 0.0;
      for (int k = 0; k < NB; ++k) s += w.lr[((size_t)k * R + r) * A + w.g[q * NB + k]];
      w.rh[(size_t)q * R + r] = s;
      m = fmax(m, s);
    }
    double s = 0.0;
    for (int q = 0; q < P; ++q) s += exp(w.rh[(size_t)q * R + r] - m);
    acc = __dadd_rn(acc, __dmul_rn(w.cnt[r], (log(s) + m) - p.log_p));
  }
  acc = warp_sum(acc);
  if (lane == 0) *w.llk = acc;
}

// one compound step of every row (assemble_mcmc.denovo_sampler's run_step
// without the swaps)
__global__ void __launch_bounds__(32 * kWarps) step_kernel(Params p) {
  __shared__ uint64_t s_eq[kWarps][kMaxP];
  __shared__ int8_t s_in[kWarps][kMaxP];
  __shared__ int8_t s_out[kWarps][kMaxP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= p.rows) return;
  const Row w = bind(p, b);
  const int P = p.P, NB = p.NB, sites = P * NB;

  // the row's draws of this step: one Philox call per two
  const uint32_t key = (uint32_t)(p.row_offset + (uint64_t)(p.row0 + b));
  for (int q = lane; 2 * q < p.D; q += 32) {
    uint32_t x[4];
    philox((uint32_t)p.step, (uint32_t)q, (uint32_t)(p.seed >> 32), (uint32_t)p.seed, key, x);
    w.u[2 * q] = uniform_f64(x[0], x[1]);
    if (2 * q + 1 < p.D) w.u[2 * q + 1] = uniform_f64(x[2], x[3]);
  }
  __syncwarp();
  for (int i = lane; i < sites; i += 32) w.order[rank_of(w.u, sites, i)] = i;
  __syncwarp();

  double llk = *w.llk;
  for (int s = 0; s < sites; ++s) {
    const int i = w.order[s];
    llk = site_step(p, w, llk, i / NB, i % NB, w.u[p.off_sites + s], lane, s_eq[warp]);
  }
  llk = structural_sweep(p, w, llk, w.u + p.off_recomb, p.p_recomb, 0, lane, s_in[warp],
                         s_out[warp]);
  llk = structural_sweep(p, w, llk, w.u + p.off_partial, p.p_partial, 1, lane, s_in[warp],
                         s_out[warp]);
  if (w.u[p.off_full] <= p.p_full)
    llk = interval_step(p, w, llk, 0, NB, 1, w.u[p.off_full + 1], lane, s_in[warp], s_out[warp]);
  if (lane == 0) *w.llk = llk;
  if (p.T == 1 && p.step >= p.burn) write_trace(p, w.n, w.g, llk, lane, 32);
}

// neighbour swaps of each chain's rungs, warmest pair first
// (assemble_mcmc.chain_swaps), then the cold rung's trace; one thread per
// chain
__global__ void swap_kernel(Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int T = p.T;
  if (c >= p.rows / T) return;
  const int b0 = c * T;
  Row w = bind(p, b0);
  for (int t = 1; t < T; ++t) {
    const int ra = b0 + t - 1, rb = b0 + t;
    const int sa = p.slot[ra], sb = p.slot[rb];
    double pa = p.llk[sa], pb = p.llk[sb];
    if (w.prior) {
      pa = pa + genotype_prior(w, p.g + (size_t)sa * p.P * p.NB, p.P, p.NB);
      pb = pb + genotype_prior(w, p.g + (size_t)sb * p.P * p.NB, p.P, p.NB);
    }
    double acc = exp(__dadd_rn(__dmul_rn(pa - pb, p.temps[t]), __dmul_rn(pb - pa, p.temps[t - 1])));
    if (acc > 1.0) acc = 1.0;
    if (acc >= p.u[(size_t)rb * p.D + p.off_swap]) {
      p.slot[ra] = sb;
      p.slot[rb] = sa;
    }
  }
  if (p.step >= p.burn) {
    const int sl = p.slot[b0 + T - 1];
    write_trace(p, w.n, p.g + (size_t)sl * p.P * p.NB, p.llk[sl], 0, 1);
  }
}

}  // namespace

extern "C" {

const char* denovo_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// per-row workspace counts (ints, option doubles, draws) of ploidy P over
// NB positions
void denovo_route_row_words(int P, int NB, int64_t* n_wi, int64_t* n_opt, int64_t* D) {
  int offs[5];
  sizes(P, NB, n_wi, n_opt, D, offs);
}

// Run rows [row0, row0 + rows) of a call (whole chains of T rungs) for
// n_steps steps: init_kernel, then per step step_kernel and, with T > 1,
// swap_kernel, on `stream` with no wait.  ptrs: lr counts nall bdist log_uh
// inbr ptab pconst logk temps init trace_g trace_llk g rh llk slot u rh_int
// opt wi; ints: S C T P NB R A row0 rows n_steps burn seed row_offset;
// reals: log_p p_recomb p_partial p_full.  Returns a CUDA error code.
int denovo_route_run(void* const* ptrs, const int64_t* ints, const double* reals, void* stream) {
  Params p = {};
  p.lr = static_cast<const double*>(ptrs[0]);
  p.counts = static_cast<const double*>(ptrs[1]);
  p.nall = static_cast<const int*>(ptrs[2]);
  p.bdist = static_cast<const double*>(ptrs[3]);
  p.log_uh = static_cast<const double*>(ptrs[4]);
  p.inbr = static_cast<const double*>(ptrs[5]);
  p.ptab = static_cast<const double*>(ptrs[6]);
  p.pconst = static_cast<const double*>(ptrs[7]);
  p.logk = static_cast<const double*>(ptrs[8]);
  p.temps = static_cast<const double*>(ptrs[9]);
  p.init = static_cast<const int8_t*>(ptrs[10]);
  p.trace_g = static_cast<int8_t*>(ptrs[11]);
  p.trace_llk = static_cast<double*>(ptrs[12]);
  p.g = static_cast<int8_t*>(ptrs[13]);
  p.rh = static_cast<double*>(ptrs[14]);
  p.llk = static_cast<double*>(ptrs[15]);
  p.slot = static_cast<int*>(ptrs[16]);
  p.u = static_cast<double*>(ptrs[17]);
  p.rh_int = static_cast<double*>(ptrs[18]);
  p.opt = static_cast<double*>(ptrs[19]);
  p.wi = static_cast<int*>(ptrs[20]);
  p.S = (int)ints[0]; p.C = (int)ints[1]; p.T = (int)ints[2]; p.P = (int)ints[3];
  p.NB = (int)ints[4]; p.R = (int)ints[5]; p.A = (int)ints[6];
  p.row0 = (int)ints[7]; p.rows = (int)ints[8];
  const int n_steps = (int)ints[9];
  p.burn = (int)ints[10];
  p.seed = (uint64_t)ints[11];
  p.row_offset = (uint64_t)ints[12];
  p.log_p = reals[0]; p.p_recomb = reals[1]; p.p_partial = reals[2]; p.p_full = reals[3];
  if (p.P < 1 || p.P > kMaxP || p.A < 1 || p.A > kMaxA || p.NB < 1 || p.T < 1 ||
      p.rows % p.T != 0 || p.row0 % p.T != 0)
    return cudaErrorInvalidValue;
  p.K = p.P * (p.P - 1);
  int64_t n_wi, n_opt, D;
  int offs[5];
  sizes(p.P, p.NB, &n_wi, &n_opt, &D, offs);
  p.n_wi = (int)n_wi;
  p.D = (int)D;
  p.off_sites = offs[0]; p.off_recomb = offs[1]; p.off_partial = offs[2];
  p.off_full = offs[3]; p.off_swap = offs[4];
  if (p.rows == 0) return cudaSuccess;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (p.rows + kWarps - 1) / kWarps;
  const int chains = p.rows / p.T;
  const int swap_blocks = (chains + 127) / 128;
  init_kernel<<<blocks, 32 * kWarps, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  for (int step = 0; step < n_steps && err == cudaSuccess; ++step) {
    p.step = step;
    step_kernel<<<blocks, 32 * kWarps, 0, s>>>(p);
    err = cudaGetLastError();
    if (err == cudaSuccess && p.T > 1) {
      swap_kernel<<<swap_blocks, 128, 0, s>>>(p);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // extern "C"
