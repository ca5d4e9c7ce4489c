// K3: the pedigree Gibbs sampler for Hopper (sm_90a).
//
// Replaces mchap_tpu/ops/pallas_pedigree.py::pallas_pedigree_sampler
// (kernel body _make_kernel, static plan _Plan).  It computes, per (locus,
// chain), the Markov chain that mchap_tpu_torch/ops/cuda_pedigree.py::
// pedigree_sampler_plain computes; see that module for the model.  Each
// compound step updates every sample in the plan's order, slots 0..P-1,
// each slot drawn by Gumbel-max over the candidates h < n_valid from
//   logit[h] = llk[h] + log trio(sample) + sum_children log trio(child)
//              + log1p(copies of h among the other slots)
// (ties to the lower allele), then does one Metropolis-Hastings allele
// swap per parental pair with the full blanket ratio.
//
// Numbers, shared with the plain version operation for operation:
// - llk[h] = sum_r counts[r] * (T[r][h] - log P) accumulated in f64 in read
//   order r = 0..R-1, with T = logaddexp(rest[r], rh[r][h]) in f32 (max +
//   log1p(exp(-|a-b|))) and rest[r] the log-sum-exp of the other slots
//   (running max from -inf, then a sum of exp from 0, in slot order).
//   Nothing is floored (the TPU kernel floors exp sums at 1e-30).
// - the trio pmf is the linear four-branch mixture D + A + B + C in f64
//   with host-computed branch weights, logged at the end (0 -> -1e300).
//   The A and B branches sum over parent p's gamete compositions, C over
//   parent q's; each sum is the coefficient of z^tau of a product of one
//   small polynomial per distinct allele (trio_log below), multiplied out
//   in allele order.  A slot's prior is its own trio, then each child's
//   in child order, added in f64 from 0.
// - log P and log1p(copies) come from host tables that the plain version
//   reads too.
// - every sample's dose is read from the live state with the candidate in
//   place (Ov below), so a selfed child sees the candidate on both sides;
//   a pair blanket lists each member once; pairs (p, p) are not in the
//   plan.
//
// What bounds it on this card: per chain-step, R*H f32 expf and log1pf per
// slot update (the read terms), plus the trio arithmetic in f64 (for a
// founder slot, H candidates x (1 + children) trios).  Bytes are small:
// the per-problem rh[S][R][H] is shared by every chain of a problem and
// stays in L1/L2.  A chain is a chain of dependent slot updates, so the
// layout is about latency:
// - one block per (locus, chain) of W warps (16 while every chain has an
//   SM of its own, fewer when chains outnumber SMs; see
//   cuda_pedigree.warps_per_block); the chain's genotypes g[S][maxp] live
//   in shared memory and block barriers order the updates;
// - the plan cuts the update order into waves, runs of consecutive samples
//   none of which is in another's Markov blanket.  A wave runs in rounds
//   of up to W members, each member on a team of W / m warps (m the
//   round's members): a founder alone on the whole block, the 20 progeny
//   of a family on one warp each and then, the last four, on four warps
//   each.  A member's slots run in turn on its team.  No member's
//   conditional reads another member's genotype, and every uniform is
//   addressed by (step, sample, slot, candidate), so the result is the
//   serial order's, bit for bit;
// - a team (synchronised by __syncwarp or a named barrier) spreads a
//   slot's read terms over (read, candidate) and its trios over (child,
//   candidate), writes them to a shared-memory tile in f64, and one thread
//   per candidate adds them in the serial order; a team-wide arg-max (xor
//   butterfly, then across the team's warps) picks the allele;
// - the trio is templated on the largest ploidy present (2, 4, 6 or 8) and
//   unrolled with predicates, so its arrays stay in registers; its
//   polynomial form costs O(P * tau^2) f64 operations with short
//   dependent chains, where enumerating the compositions costs up to
//   (P + 1)^(P - 1) iterations of a P-long product; the binomial and 1/e!
//   tables sit in shared memory, where lanes read them at different
//   addresses;
// - a pair swap spreads its reads and blanket over the block and sums the
//   parts in a fixed order.
// Uniforms come from Philox4x32-10 with key (seed, chain) and counter
// (step, draw / 4, 0, seed >> 32), or from a pinned noise[T][D][C] where
// draw d = (s * maxp + k) * H + h for slots and S * maxp * H + 3 * pair +
// {0, 1, 2} for a pair's p slot, q slot and acceptance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP = 8;
// warps per block: 16 for P <= 4 (ptxas then has 128 registers a thread);
// 8 above, where the trio's arrays need more
constexpr int max_warps(int maxp) { return maxp <= 4 ? 16 : 8; }
constexpr int kTile = 1024;  // f64 scratch per warp
constexpr double kNeg = -1e300;
constexpr int kTables = (kMaxP + 1) * (kMaxP + 1) + 2 * (kMaxP + 1);

__constant__ double kComb[kMaxP + 1][kMaxP + 1] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0},      {1, 1, 0, 0, 0, 0, 0, 0, 0},
    {1, 2, 1, 0, 0, 0, 0, 0, 0},      {1, 3, 3, 1, 0, 0, 0, 0, 0},
    {1, 4, 6, 4, 1, 0, 0, 0, 0},      {1, 5, 10, 10, 5, 1, 0, 0, 0},
    {1, 6, 15, 20, 15, 6, 1, 0, 0},   {1, 7, 21, 35, 35, 21, 7, 1, 0},
    {1, 8, 28, 56, 70, 56, 28, 8, 1}};
__constant__ double kInvFact[kMaxP + 1] = {
    1.0, 1.0, 1.0 / 2.0, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0,
    1.0 / 720.0, 1.0 / 5040.0, 1.0 / 40320.0};

struct Params {
  const float* rh;       // [N][S][R][H]
  const float* counts;   // [N][S][R]
  const double* freqs;   // [N][H] linear
  const int* n_valid;    // [N]
  const int* problem;    // [C]
  const int* initial;    // [C][S][maxp]
  const float* noise;    // [n_steps][D][C] or null
  const int* order;      // [S]
  const int* ploidy;     // [S]
  const int* parents;    // [S][2]
  const int* tau;        // [S][2]
  const int* child_ptr;  // [S + 1]
  const int* child_idx;
  const int* pairs;        // [n_pairs][2]
  const int* blanket_ptr;  // [n_pairs + 1]
  const int* blanket_idx;
  const int* wave_ptr;     // [n_waves + 1], into order
  // [S][4] (A, B, C, D), then log P and log1p(P) for P = 0..8
  const double* weights;
  int16_t* trace;  // [C][n_steps][S][maxp]
  int N, S, R, H, C, maxp, n_pairs, n_waves, n_steps, D, rmax;
  uint64_t seed;
};

// The block's shared memory.
struct Shared {
  const double* comb;      // [9][9]
  const double* inv_fact;  // [9]
  const double* log1p;     // [9]
  double* red_s;           // [W] cross-warp reductions
  int* red_h;              // [W]
  int* g;                  // [S][maxp]
  const double* fr;        // this chain's frequencies (global)
};

// The threads that update one sample: nw consecutive warps from warp w0
// (one warp, a few, or the whole block), synchronised by __syncwarp or by
// the named barrier bar.  Its tile holds nw * kTile doubles, its rest
// nw * rmax floats.
struct Team {
  int tid, n, w0, nw, bar;
  double* tile;
  float* rest;
  __device__ __forceinline__ void sync() const {
    if (nw == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
  }
};

__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1, uint32_t c2,
                                                uint32_t c3, uint32_t k0, uint32_t k1,
                                                int word) {
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

__device__ __forceinline__ float uniform(const Params& p, int c, int step, int d) {
  if (p.noise) return __ldg(p.noise + ((size_t)step * p.D + d) * p.C + c);
  const uint32_t bits = philox_word((uint32_t)step, (uint32_t)(d >> 2), 0u,
                                    (uint32_t)(p.seed >> 32), (uint32_t)p.seed,
                                    (uint32_t)c, d & 3);
  return fmaxf((float)(bits >> 9) * (1.0f / 8388608.0f), 1e-12f);
}

// Up to two single-slot overrides of the live state: sample s1 slot k1
// holds v1 and sample s2 slot k2 holds v2 (s = -1: none).
struct Ov {
  int s1, k1, v1, s2, k2, v2;
};

__device__ __forceinline__ int allele(const int* g, int maxp, const Ov& ov, int y, int j) {
  if (y == ov.s1 && j == ov.k1) return ov.v1;
  if (y == ov.s2 && j == ov.k2) return ov.v2;
  return g[y * maxp + j];
}

// In place, q <- q * c truncated at degree tmax <= PM: q[t] = q[t] c[0] +
// q[t-1] c[1] + ... + q[0] c[t], added in that order.
template <int PM>
__device__ __forceinline__ void poly_mul(double (&q)[PM + 1], const double (&c)[PM + 1], int tmax) {
#pragma unroll
  for (int t = PM; t >= 0; --t) {
    if (t <= tmax) {
      double s = __dmul_rn(q[t], c[0]);
#pragma unroll
      for (int x = 1; x <= t; ++x) s = __dadd_rn(s, __dmul_rn(q[t - x], c[x]));
      q[t] = s;
    }
  }
}

template <int PM>
__device__ __forceinline__ double coef(const double (&q)[PM + 1], int t) {
  double r = 0.0;
#pragma unroll
  for (int i = 0; i <= PM; ++i)
    if (i == t) r = q[i];
  return r;
}

// log trio pmf of sample x under the live state with overrides ov.  Each
// branch's sum over gamete compositions is the coefficient of z^tau of a
// product over the distinct alleles j (d_j copies, a_j in parent p, b_j in
// parent q, frequency f_j) of polynomials in the gamete's dose x of j:
//   A: C(a_j, x) C(b_j, d_j - x)     B: C(a_j, x) f_j^(d_j - x) / (d_j - x)!
//   C: C(b_j, x) f_j^(d_j - x) / (d_j - x)!
// and D is the product of f_j^d_j / d_j!.  Unrolled over PM >= P with
// predicates, so every array stays in registers.
template <int PM>
__device__ double trio_log(const Params& p, const Shared& sh, int x, const Ov& ov) {
  const int maxp = p.maxp;
  const int P = __ldg(p.ploidy + x);
  const int pp = __ldg(p.parents + 2 * x), pq = __ldg(p.parents + 2 * x + 1);
  const int np = pp >= 0 ? __ldg(p.ploidy + pp) : 0;
  const int nq = pq >= 0 ? __ldg(p.ploidy + pq) : 0;
  const int tp = __ldg(p.tau + 2 * x), tq = __ldg(p.tau + 2 * x + 1);
  int v[PM], ap[PM], aq[PM];
#pragma unroll
  for (int j = 0; j < PM; ++j) {
    v[j] = j < P ? allele(sh.g, maxp, ov, x, j) : -1;
    ap[j] = j < np ? allele(sh.g, maxp, ov, pp, j) : -2;
    aq[j] = j < nq ? allele(sh.g, maxp, ov, pq, j) : -2;
  }
  const double* comb = sh.comb;
  double qa[PM + 1], qb[PM + 1], qc[PM + 1], uv[PM + 1], cf[PM + 1];
#pragma unroll
  for (int t = 0; t <= PM; ++t) qa[t] = qb[t] = qc[t] = t == 0 ? 1.0 : 0.0;
  double pd = 1.0;
#pragma unroll
  for (int j = 0; j < PM; ++j) {
    int d = 0, a = 0, b = 0;
    bool first = true;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const bool eq = i < P && v[i] == v[j];
      d += eq;
      if (eq && i < j) first = false;
      a += ap[i] == v[j];
      b += aq[i] == v[j];
    }
    if (j < P && first) {  // a non-first slot's factors are 1
      // uv[x] = f^(d - x) / (d - x)!, the power by repeated multiplication
      const double f = __ldg(sh.fr + v[j]);
      double run = 1.0;
#pragma unroll
      for (int e = PM; e >= 0; --e) {
        uv[e] = 0.0;
        if (e <= d) {
          uv[e] = __dmul_rn(run, sh.inv_fact[d - e]);
          run = __dmul_rn(run, f);
        }
      }
      pd = __dmul_rn(pd, uv[0]);
#pragma unroll
      for (int e = 0; e <= PM; ++e)
        cf[e] = e <= d ? __dmul_rn(comb[a * 9 + e], comb[b * 9 + d - e]) : 0.0;
      poly_mul<PM>(qa, cf, tp);
#pragma unroll
      for (int e = 0; e <= PM; ++e) cf[e] = __dmul_rn(comb[a * 9 + e], uv[e]);
      poly_mul<PM>(qb, cf, tp);
#pragma unroll
      for (int e = 0; e <= PM; ++e) cf[e] = __dmul_rn(comb[b * 9 + e], uv[e]);
      poly_mul<PM>(qc, cf, tq);
    }
  }
  const double wa = __ldg(p.weights + 4 * x), wb = __ldg(p.weights + 4 * x + 1);
  const double wc = __ldg(p.weights + 4 * x + 2), wd = __ldg(p.weights + 4 * x + 3);
  double total = 0.0;
  if (wd > 0.0) total = __dmul_rn(wd, pd);
  if (wa > 0.0) total = __dadd_rn(total, __dmul_rn(wa, coef<PM>(qa, tp)));
  if (wb > 0.0) total = __dadd_rn(total, __dmul_rn(wb, coef<PM>(qb, tp)));
  if (wc > 0.0) total = __dadd_rn(total, __dmul_rn(wc, coef<PM>(qc, tq)));
  return total > 0.0 ? log(total) : kNeg;
}

// log-sum-exp over the slots of sample row g_s except slot skip, for read r
__device__ __forceinline__ float rest_of(const float* rh_r, const int* g_s, int P, int skip) {
  float m = -INFINITY;
  for (int j = 0; j < P; ++j)
    if (j != skip) m = fmaxf(m, __ldg(rh_r + g_s[j]));
  float s = 0.f;
  for (int j = 0; j < P; ++j)
    if (j != skip) s = __fadd_rn(s, expf(__fsub_rn(__ldg(rh_r + g_s[j]), m)));
  return __fadd_rn(m, logf(s));
}

__device__ __forceinline__ float log_add(float a, float b) {
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __dadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Sum of x over the block: lanes by xor butterfly, then warps in order.
__device__ __forceinline__ double block_sum(const Shared& sh, double x) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) sh.red_s[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = sh.red_s[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) total = __dadd_rn(total, sh.red_s[w]);
  __syncthreads();
  return total;
}

__device__ __forceinline__ void keep_best(double& best_s, int& best_h, double s, int h) {
  if (s > best_s || (s == best_s && h < best_h)) {
    best_s = s;
    best_h = h;
  }
}

__device__ __forceinline__ void warp_best(double& best_s, int& best_h) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double os = __shfl_xor_sync(kFull, best_s, o);
    const int oh = __shfl_xor_sync(kFull, best_h, o);
    keep_best(best_s, best_h, os, oh);
  }
}

// Gibbs update of slot k of sample s by team t.
template <int PM>
__device__ void update_slot(const Params& p, const Shared& sh, const Team& t, int c,
                            int prob, int nv, int step, int s, int k) {
  const int S = p.S, R = p.R, H = p.H, maxp = p.maxp;
  const int P = __ldg(p.ploidy + s);
  const float* rh_s = p.rh + ((size_t)prob * S + s) * R * H;
  const float* cnt_s = p.counts + ((size_t)prob * S + s) * R;
  const double lp = __ldg(p.weights + 4 * S + P);
  const int* g_s = sh.g + s * maxp;
  const int c0 = __ldg(p.child_ptr + s);
  const int n_items = 1 + __ldg(p.child_ptr + s + 1) - c0;  // own trio, then children
  const int cap = t.n / 32 * kTile;
  const int width = min(nv, t.n);
  double best_s = -INFINITY;
  int best_h = 0x7fffffff;
#pragma unroll 1
  for (int h0 = 0; h0 < nv; h0 += width) {
    const int cw = min(width, nv - h0);
    // the candidate's Gumbel noise and copies, off the serial path
    double gumbel = 0.0, log1p_copies = 0.0;
    if (t.tid < cw) {
      const int h = h0 + t.tid;
      int copies = 0;
      for (int j = 0; j < P; ++j) copies += (j != k) && (g_s[j] == h);
      log1p_copies = sh.log1p[copies];
      gumbel = log(-log((double)uniform(p, c, step, (s * maxp + k) * H + h)));
    }
    // i / cw as __umulhi(i, magic), exact for i * cw < 2^32
    const uint32_t magic = (uint32_t)((0x100000000ull + cw - 1) / cw);
    // llk: read terms over (read, candidate), summed per candidate in read
    // order.  Thread tid takes candidate h0 + hh and reads rr, rr + dr, ...
    // (the last n - dr * cw threads idle).
    const int rc_max = min(R, cap / cw);
    const int dr = t.n / cw, rr = __umulhi(t.tid, magic), hh = t.tid - rr * cw;
    double l = 0.0;
#pragma unroll 1
    for (int r0 = 0; r0 < R; r0 += rc_max) {
      const int rc = min(rc_max, R - r0);
      for (int i = t.tid; i < rc; i += t.n)
        t.rest[i] = rest_of(rh_s + (size_t)(r0 + i) * H, g_s, P, k);
      t.sync();
      const float* rh_r = rh_s + (size_t)(r0 + rr) * H + h0 + hh;
#pragma unroll 4
      for (int r = rr < dr ? rr : rc; r < rc; r += dr, rh_r += (size_t)dr * H) {
        const float term = log_add(t.rest[r], __ldg(rh_r));
        t.tile[r * cw + hh] = __dmul_rn(__dsub_rn((double)term, lp), (double)__ldg(cnt_s + r0 + r));
      }
      t.sync();
      if (t.tid < cw) {
#pragma unroll 8
        for (int r = 0; r < rc; ++r) l = __dadd_rn(l, t.tile[r * cw + t.tid]);
      }
      t.sync();
    }
    // prior: trios over (item, candidate), summed per candidate in item order
    const int ic_max = cap / cw;
    double prior = 0.0;
#pragma unroll 1
    for (int j0 = 0; j0 < n_items; j0 += ic_max) {
      const int ic = min(ic_max, n_items - j0);
      for (int i = t.tid; i < ic * cw; i += t.n) {
        const int jj = __umulhi(i, magic), j = j0 + jj, h = h0 + i - jj * cw;
        const int x = j == 0 ? s : __ldg(p.child_idx + c0 + j - 1);
        t.tile[i] = trio_log<PM>(p, sh, x, Ov{s, k, h, -1, -1, 0});
      }
      t.sync();
      if (t.tid < cw) {
#pragma unroll 8
        for (int j = 0; j < ic; ++j) prior = __dadd_rn(prior, t.tile[j * cw + t.tid]);
      }
      t.sync();
    }
    if (t.tid < cw)
      keep_best(best_s, best_h, __dsub_rn(__dadd_rn(__dadd_rn(l, prior), log1p_copies), gumbel),
                h0 + t.tid);
  }
  // arg-max over the team: lanes by xor butterfly (the winner in every
  // lane), then the team's warp winners the same way in every warp
  warp_best(best_s, best_h);
  if (t.nw > 1) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sh.red_s[threadIdx.x >> 5] = best_s;
      sh.red_h[threadIdx.x >> 5] = best_h;
    }
    t.sync();
    const bool mine = lane < t.nw;
    best_s = mine ? sh.red_s[t.w0 + lane] : -INFINITY;
    best_h = mine ? sh.red_h[t.w0 + lane] : 0x7fffffff;
    warp_best(best_s, best_h);
  }
  if (best_h == 0x7fffffff) best_h = 0;  // every score NaN: keep in bounds
  t.sync();
  if (t.tid == 0) sh.g[s * maxp + k] = best_h;
  t.sync();
}

// One MH allele swap between samples sp != sq, by the whole block.
template <int PM>
__device__ void pair_swap(const Params& p, const Shared& sh, int c, int prob, int step, int pi) {
  const int S = p.S, R = p.R, H = p.H, maxp = p.maxp;
  const int* g = sh.g;
  const int sp = __ldg(p.pairs + 2 * pi), sq = __ldg(p.pairs + 2 * pi + 1);
  const int pp = __ldg(p.ploidy + sp), pq = __ldg(p.ploidy + sq);
  const int base = S * maxp * H + 3 * pi;
  const float u0 = uniform(p, c, step, base), u1 = uniform(p, c, step, base + 1);
  const float u2 = uniform(p, c, step, base + 2);
  const int ip = min((int)(__fmul_rn(u0, (float)pp)), pp - 1);
  const int iq = min((int)(__fmul_rn(u1, (float)pq)), pq - 1);
  const int ap = g[sp * maxp + ip], aq = g[sq * maxp + iq];
  if (ap == aq) return;  // no proposal; the same in every thread
  int c_pp = 0, c_pq = 0, c_qq = 0, c_qp = 0;
  for (int j = 0; j < pp; ++j) {
    c_pp += g[sp * maxp + j] == ap;
    c_pq += g[sp * maxp + j] == aq;
  }
  for (int j = 0; j < pq; ++j) {
    c_qq += g[sq * maxp + j] == aq;
    c_qp += g[sq * maxp + j] == ap;
  }
  const double proposal = __dmul_rn((double)c_pp, (double)c_qq);
  const double reversal = __dmul_rn(1.0 + (double)c_pq, 1.0 + (double)c_qp);
  const double lproposal = __dsub_rn(log(reversal), log(fmax(proposal, 1.0)));
  // llk change of p and q, threads over (side, read)
  double part = 0.0;
  for (int i = threadIdx.x; i < 2 * R; i += blockDim.x) {
    const int side = i >= R, r = i - side * R;
    const int s = side ? sq : sp, P = side ? pq : pp, idx = side ? iq : ip;
    const int na = side ? ap : aq;
    const float* rh_r = p.rh + (((size_t)prob * S + s) * R + r) * H;
    const float rs = rest_of(rh_r, g + s * maxp, P, idx);
    const float old_t = log_add(rs, __ldg(rh_r + g[s * maxp + idx]));
    const float new_t = log_add(rs, __ldg(rh_r + na));
    part = __dadd_rn(part, __dmul_rn(__dsub_rn((double)new_t, (double)old_t),
                                     (double)__ldg(p.counts + ((size_t)prob * S + s) * R + r)));
  }
  const double dllk = block_sum(sh, part);
  // prior change over the blanket, threads over members
  const Ov prop{sp, ip, aq, sq, iq, ap};
  const Ov none{-1, -1, 0, -1, -1, 0};
  double dpart = 0.0;
  for (int bi = __ldg(p.blanket_ptr + pi) + threadIdx.x; bi < __ldg(p.blanket_ptr + pi + 1);
       bi += blockDim.x) {
    const int x = __ldg(p.blanket_idx + bi);
    dpart = __dadd_rn(dpart, __dsub_rn(trio_log<PM>(p, sh, x, prop), trio_log<PM>(p, sh, x, none)));
  }
  const double dprior = block_sum(sh, dpart);
  const double log_acc = fmin(0.0, __dadd_rn(__dadd_rn(dllk, dprior), lproposal));
  if (threadIdx.x == 0 && (double)u2 < exp(log_acc)) {
    sh.g[sp * maxp + ip] = aq;
    sh.g[sq * maxp + iq] = ap;
  }
  __syncthreads();
}

template <int PM>
__global__ void __launch_bounds__(max_warps(PM) * 32) pedigree_kernel(Params p) {
  extern __shared__ __align__(16) double smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  const int S = p.S, maxp = p.maxp;
  double* tables = smem;              // comb, 1/e!, log1p
  double* tile = tables + kTables;    // [W][kTile]
  double* red_s = tile + W * kTile;   // [W]
  float* rest = reinterpret_cast<float*>(red_s + W);  // [W][rmax]
  int* red_h = reinterpret_cast<int*>(rest + W * p.rmax);  // [W]
  int* g = red_h + W;                                      // [S][maxp]
  const int prob = p.problem[c];
  const int nv = p.n_valid[prob];
  for (int i = threadIdx.x; i < (kMaxP + 1) * (kMaxP + 1); i += blockDim.x)
    tables[i] = kComb[i / (kMaxP + 1)][i % (kMaxP + 1)];
  for (int i = threadIdx.x; i <= kMaxP; i += blockDim.x) {
    tables[81 + i] = kInvFact[i];
    tables[90 + i] = p.weights[4 * S + kMaxP + 1 + i];
  }
  for (int i = threadIdx.x; i < S * maxp; i += blockDim.x)
    g[i] = p.initial[(size_t)c * S * maxp + i];
  const Shared sh{tables, tables + 81, tables + 90, red_s, red_h, g, p.freqs + (size_t)prob * p.H};
  __syncthreads();

#pragma unroll 1
  for (int step = 0; step < p.n_steps; ++step) {
#pragma unroll 1
    for (int wi = 0; wi < p.n_waves; ++wi) {
      const int lo = __ldg(p.wave_ptr + wi), hi = __ldg(p.wave_ptr + wi + 1);
      // rounds of up to W members; a round of m members gives each W / m
      // warps (a lone founder gets the block)
#pragma unroll 1
      for (int base = lo; base < hi; base += W) {
        const int nw = W / min(W, hi - base), ti = warp / nw;
        if (base + ti < hi) {
          const Team t{(warp - ti * nw) * 32 + lane, nw * 32, ti * nw, nw, 1 + ti,
                       tile + ti * nw * kTile, rest + ti * nw * p.rmax};
          const int s = __ldg(p.order + base + ti);
          const int P = __ldg(p.ploidy + s);
#pragma unroll 1
          for (int k = 0; k < P; ++k) update_slot<PM>(p, sh, t, c, prob, nv, step, s, k);
        }
        __syncthreads();
      }
    }
    // parental-pair allele swaps (reference mcmc.py:503-655)
#pragma unroll 1
    for (int pi = 0; pi < p.n_pairs; ++pi) pair_swap<PM>(p, sh, c, prob, step, pi);

    int16_t* out = p.trace + ((size_t)c * p.n_steps + step) * S * maxp;
    for (int i = threadIdx.x; i < S * maxp; i += blockDim.x) out[i] = (int16_t)g[i];
    __syncthreads();
  }
}

template <int PM>
int launch(const Params& p, int warps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pedigree_kernel<PM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pedigree_kernel<PM><<<p.C, 32 * warps, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one chain's block of `warps` warps: the tables, each
// warp's f64 tile, rest and reduction slots, and every sample's genotype.
int64_t pedigree_sampler_smem_bytes(int S, int maxp, int R, int warps) {
  const int64_t rmax = R < kTile ? R : kTile;
  return 8 * (kTables + (int64_t)warps * (kTile + 1)) + 4 * (warps * (rmax + 1) + (int64_t)S * maxp);
}

int pedigree_sampler_max_warps(int maxp) { return max_warps(maxp); }

const char* pedigree_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pedigree_sampler_launch(const void* rh, const void* counts, const void* freqs,
                            const void* n_valid, const void* problem, const void* initial,
                            const void* noise, const void* ints, const void* weights,
                            int o_order, int o_ploidy, int o_parents, int o_tau,
                            int o_child_ptr, int o_child_idx, int o_pairs,
                            int o_blanket_ptr, int o_blanket_idx, int o_wave_ptr,
                            void* trace, int N, int S, int R, int H, int C, int maxp,
                            int n_pairs, int n_waves, int n_steps, uint64_t seed, int warps,
                            void* stream) {
  if (C == 0 || n_steps == 0) return cudaSuccess;
  if (maxp < 1 || maxp > kMaxP || warps < 1 || warps > max_warps(maxp))
    return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(ints);
  Params p;
  p.rh = static_cast<const float*>(rh);
  p.counts = static_cast<const float*>(counts);
  p.freqs = static_cast<const double*>(freqs);
  p.n_valid = static_cast<const int*>(n_valid);
  p.problem = static_cast<const int*>(problem);
  p.initial = static_cast<const int*>(initial);
  p.noise = static_cast<const float*>(noise);
  p.order = t + o_order;
  p.ploidy = t + o_ploidy;
  p.parents = t + o_parents;
  p.tau = t + o_tau;
  p.child_ptr = t + o_child_ptr;
  p.child_idx = t + o_child_idx;
  p.pairs = t + o_pairs;
  p.blanket_ptr = t + o_blanket_ptr;
  p.blanket_idx = t + o_blanket_idx;
  p.wave_ptr = t + o_wave_ptr;
  p.weights = static_cast<const double*>(weights);
  p.trace = static_cast<int16_t*>(trace);
  p.N = N; p.S = S; p.R = R; p.H = H; p.C = C; p.maxp = maxp;
  p.n_pairs = n_pairs; p.n_waves = n_waves; p.n_steps = n_steps;
  p.D = S * maxp * H + 3 * n_pairs;
  p.rmax = R < kTile ? R : kTile;
  p.seed = seed;
  const size_t smem = (size_t)pedigree_sampler_smem_bytes(S, maxp, R, warps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maxp <= 2) return launch<2>(p, warps, smem, st);
  if (maxp <= 4) return launch<4>(p, warps, smem, st);
  if (maxp <= 6) return launch<6>(p, warps, smem, st);
  return launch<8>(p, warps, smem, st);
}

}  // extern "C"
