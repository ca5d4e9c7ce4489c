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
// - llk[h] = sum_r counts[r] * (T[r][h] - log P) accumulated in f64, with
//   T = logaddexp(rest[r], rh[r][h]) in f32 (max + log1p(exp(-|a-b|))) and
//   rest[r] the log-sum-exp of the other slots (running max from -inf, then
//   a sum of exp from 0, in slot order).  Nothing is floored: a read far
//   below every current haplotype keeps its exact term (the TPU kernel
//   floors exp sums at 1e-30).
// - the trio pmf is the linear four-branch mixture (D, then A and B over
//   the parent-p gamete compositions allowed by the dosages, in odometer
//   order, then C over parent-q's) in f64 with host-computed branch
//   weights, logged at the end (0 -> -1e300).
// - every sample's dose is read from the live state with the candidate in
//   place (Ov below), so a selfed child sees the candidate on both sides;
//   a pair blanket lists each member once; pairs (p, p) are not in the
//   plan.
//
// What bounds it on this card: per chain-step, R*H f32 expf and log1pf per
// slot update (the read terms), plus the trio arithmetic in f64 (for a
// founder slot, H candidates x (1 + children) trios).  Bytes are small:
// the per-problem rh[S][R][H] is shared by every chain of a problem and
// stays in L1/L2.  The first version is simple and right: one warp per
// chain, lanes over candidates (h += 32), the genotype of every sample and
// each read's rest in shared memory, a warp arg-max by xor butterfly that
// leaves the winner in every lane.  Uniforms come from Philox4x32-10 with
// key (seed, chain) and counter (step, draw / 4, 0, seed >> 32), or from a
// pinned noise[T][D][C] where draw d = (s * maxp + k) * H + h for slots and
// S * maxp * H + 3 * pair + {0, 1, 2} for a pair's p slot, q slot and
// acceptance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP = 8;
constexpr double kNeg = -1e300;

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
  const double* weights;  // [S][4] (A, B, C, D), then log P for P = 0..8
  int16_t* trace;         // [C][n_steps][S][maxp]
  int N, S, R, H, C, maxp, n_pairs, n_steps, D, warps;
  uint64_t seed;
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

__device__ __forceinline__ double un(double f, int e) {
  double r = 1.0;
  for (int i = 0; i < e; ++i) r = __dmul_rn(r, f);
  return __dmul_rn(r, kInvFact[e]);
}

// Visit every x[0..P) with sum tau and 0 <= x[j] <= lim[j], in odometer
// order (x[0] fastest, x[P-1] determined by the others).
template <typename F>
__device__ __forceinline__ void compositions(int P, int tau, const int* lim, F&& body) {
  int x[kMaxP];
  for (int j = 0; j < P; ++j) x[j] = 0;
  while (true) {
    int rem = tau;
    for (int j = 0; j < P - 1; ++j) rem -= x[j];
    if (rem >= 0 && rem <= lim[P - 1]) {
      x[P - 1] = rem;
      body(x);
    }
    int j = 0;
    while (j < P - 1) {
      if (x[j] < lim[j]) { ++x[j]; break; }
      x[j] = 0;
      ++j;
    }
    if (j >= P - 1) break;
  }
}

// log trio pmf of sample x under the live state with overrides ov.
__device__ double trio_log(const Params& p, const int* g, const double* fr, int x,
                           const Ov& ov) {
  const int P = p.ploidy[x];
  const int pp = p.parents[2 * x], pq = p.parents[2 * x + 1];
  int v[kMaxP], d[kMaxP], a[kMaxP], b[kMaxP], la[kMaxP], lb[kMaxP];
  double f[kMaxP];
  for (int j = 0; j < P; ++j) v[j] = allele(g, p.maxp, ov, x, j);
  for (int j = 0; j < P; ++j) {
    int cnt = 0;
    bool first = true;
    for (int i = 0; i < P; ++i) {
      if (v[i] == v[j]) {
        ++cnt;
        if (i < j) first = false;
      }
    }
    d[j] = first ? cnt : 0;
    a[j] = 0;
    b[j] = 0;
    if (pp >= 0)
      for (int i = 0; i < p.ploidy[pp]; ++i) a[j] += allele(g, p.maxp, ov, pp, i) == v[j];
    if (pq >= 0)
      for (int i = 0; i < p.ploidy[pq]; ++i) b[j] += allele(g, p.maxp, ov, pq, i) == v[j];
    la[j] = min(d[j], a[j]);
    lb[j] = min(d[j], b[j]);
    f[j] = __ldg(fr + v[j]);
  }
  const double wa = p.weights[4 * x], wb = p.weights[4 * x + 1];
  const double wc = p.weights[4 * x + 2], wd = p.weights[4 * x + 3];
  double total = 0.0;
  if (wd > 0.0) {
    double pr = un(f[0], d[0]);
    for (int j = 1; j < P; ++j) pr = __dmul_rn(pr, un(f[j], d[j]));
    total = __dmul_rn(wd, pr);
  }
  if (wa > 0.0 || wb > 0.0) {
    compositions(P, p.tau[2 * x], la, [&](const int* xs) {
      double cp = kComb[a[0]][xs[0]];
      for (int j = 1; j < P; ++j) cp = __dmul_rn(cp, kComb[a[j]][xs[j]]);
      if (wa > 0.0) {
        double pr = kComb[b[0]][d[0] - xs[0]];
        for (int j = 1; j < P; ++j) pr = __dmul_rn(pr, kComb[b[j]][d[j] - xs[j]]);
        total = __dadd_rn(total, __dmul_rn(__dmul_rn(wa, cp), pr));
      }
      if (wb > 0.0) {
        double pr = un(f[0], d[0] - xs[0]);
        for (int j = 1; j < P; ++j) pr = __dmul_rn(pr, un(f[j], d[j] - xs[j]));
        total = __dadd_rn(total, __dmul_rn(__dmul_rn(wb, cp), pr));
      }
    });
  }
  if (wc > 0.0) {
    compositions(P, p.tau[2 * x + 1], lb, [&](const int* ys) {
      double cq = kComb[b[0]][ys[0]];
      for (int j = 1; j < P; ++j) cq = __dmul_rn(cq, kComb[b[j]][ys[j]]);
      double pr = un(f[0], d[0] - ys[0]);
      for (int j = 1; j < P; ++j) pr = __dmul_rn(pr, un(f[j], d[j] - ys[j]));
      total = __dadd_rn(total, __dmul_rn(__dmul_rn(wc, cq), pr));
    });
  }
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

__global__ void __launch_bounds__(128) pedigree_kernel(Params p) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * p.warps + warp;
  if (c >= p.C) return;  // whole warp leaves; there are no block barriers

  const int S = p.S, R = p.R, H = p.H, maxp = p.maxp;
  const int per_warp = S * maxp + R;
  int* g = smem + (size_t)warp * per_warp;              // [S][maxp]
  float* rest = reinterpret_cast<float*>(g + S * maxp);  // [R]
  const int prob = p.problem[c];
  const int nv = p.n_valid[prob];
  const double* fr = p.freqs + (size_t)prob * H;
  const double* log_p = p.weights + 4 * S;
  const Ov none{-1, -1, 0, -1, -1, 0};
  for (int i = lane; i < S * maxp; i += 32) g[i] = p.initial[(size_t)c * S * maxp + i];
  __syncwarp();

#pragma unroll 1
  for (int step = 0; step < p.n_steps; ++step) {
#pragma unroll 1
    for (int oi = 0; oi < S; ++oi) {
      const int s = p.order[oi];
      const int P = p.ploidy[s];
      const float* rh_s = p.rh + ((size_t)prob * S + s) * R * H;
      const float* cnt_s = p.counts + ((size_t)prob * S + s) * R;
      const double lp = log_p[P];
#pragma unroll 1
      for (int k = 0; k < P; ++k) {
        for (int r = lane; r < R; r += 32) rest[r] = rest_of(rh_s + (size_t)r * H, g + s * maxp, P, k);
        __syncwarp();
        double best_s = -INFINITY;
        int best_h = 0x7fffffff;
        for (int h = lane; h < nv; h += 32) {
          double l = 0.0;
#pragma unroll 4
          for (int r = 0; r < R; ++r) {
            const float t = log_add(rest[r], __ldg(rh_s + (size_t)r * H + h));
            l = __dadd_rn(l, __dmul_rn(__dsub_rn((double)t, lp), (double)__ldg(cnt_s + r)));
          }
          const Ov ov{s, k, h, -1, -1, 0};
          double prior = trio_log(p, g, fr, s, ov);
          for (int ci = p.child_ptr[s]; ci < p.child_ptr[s + 1]; ++ci)
            prior = __dadd_rn(prior, trio_log(p, g, fr, p.child_idx[ci], ov));
          int copies = 0;
          for (int j = 0; j < P; ++j) copies += (j != k) && (g[s * maxp + j] == h);
          const double logit = __dadd_rn(__dadd_rn(l, prior), log1p((double)copies));
          const double u = (double)uniform(p, c, step, (s * maxp + k) * H + h);
          const double score = __dsub_rn(logit, log(-log(u)));
          if (score > best_s || (score == best_s && h < best_h)) {
            best_s = score;
            best_h = h;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const double os = __shfl_xor_sync(kFull, best_s, o);
          const int oh = __shfl_xor_sync(kFull, best_h, o);
          if (os > best_s || (os == best_s && oh < best_h)) {
            best_s = os;
            best_h = oh;
          }
        }
        if (best_h == 0x7fffffff) best_h = 0;  // every score NaN: keep in bounds
        __syncwarp();
        if (lane == 0) g[s * maxp + k] = best_h;
        __syncwarp();
      }
    }

    // parental-pair allele swaps (reference mcmc.py:503-655)
#pragma unroll 1
    for (int pi = 0; pi < p.n_pairs; ++pi) {
      const int sp = p.pairs[2 * pi], sq = p.pairs[2 * pi + 1];
      const int pp = p.ploidy[sp], pq = p.ploidy[sq];
      const int base = S * maxp * H + 3 * pi;
      const float u0 = uniform(p, c, step, base), u1 = uniform(p, c, step, base + 1);
      const float u2 = uniform(p, c, step, base + 2);
      const int ip = min((int)(__fmul_rn(u0, (float)pp)), pp - 1);
      const int iq = min((int)(__fmul_rn(u1, (float)pq)), pq - 1);
      const int ap = g[sp * maxp + ip], aq = g[sq * maxp + iq];
      if (ap == aq) continue;  // no proposal; the same in every lane
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
      // llk change of p and q, lanes over reads
      double part = 0.0;
      for (int side = 0; side < 2; ++side) {
        const int s = side ? sq : sp, P = side ? pq : pp, idx = side ? iq : ip;
        const int na = side ? ap : aq;
        const float* rh_s = p.rh + ((size_t)prob * S + s) * R * H;
        const float* cnt_s = p.counts + ((size_t)prob * S + s) * R;
        for (int r = lane; r < R; r += 32) {
          const float* rh_r = rh_s + (size_t)r * H;
          const float rs = rest_of(rh_r, g + s * maxp, P, idx);
          const float old_t = log_add(rs, __ldg(rh_r + g[s * maxp + idx]));
          const float new_t = log_add(rs, __ldg(rh_r + na));
          part = __dadd_rn(part, __dmul_rn(__dsub_rn((double)new_t, (double)old_t),
                                           (double)__ldg(cnt_s + r)));
        }
      }
      const double dllk = warp_sum(part);
      // prior change over the blanket, lanes over members
      const Ov prop{sp, ip, aq, sq, iq, ap};
      double dpart = 0.0;
      for (int bi = p.blanket_ptr[pi] + lane; bi < p.blanket_ptr[pi + 1]; bi += 32) {
        const int x = p.blanket_idx[bi];
        dpart = __dadd_rn(dpart, __dsub_rn(trio_log(p, g, fr, x, prop), trio_log(p, g, fr, x, none)));
      }
      const double dprior = warp_sum(dpart);
      const double log_acc = fmin(0.0, __dadd_rn(__dadd_rn(dllk, dprior), lproposal));
      const bool accept = (double)u2 < exp(log_acc);
      __syncwarp();
      if (accept && lane == 0) {
        g[sp * maxp + ip] = aq;
        g[sq * maxp + iq] = ap;
      }
      __syncwarp();
    }

    int16_t* out = p.trace + ((size_t)c * p.n_steps + step) * S * maxp;
    for (int i = lane; i < S * maxp; i += 32) out[i] = (int16_t)g[i];
  }
}

}  // namespace

extern "C" {

// Shared memory one chain-warp needs: every sample's genotype, each read's rest.
int64_t pedigree_sampler_smem_bytes(int S, int maxp, int R) {
  return (int64_t)(S * maxp + R) * 4;
}

const char* pedigree_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pedigree_sampler_launch(const void* rh, const void* counts, const void* freqs,
                            const void* n_valid, const void* problem, const void* initial,
                            const void* noise, const void* ints, const void* weights,
                            int o_order, int o_ploidy, int o_parents, int o_tau,
                            int o_child_ptr, int o_child_idx, int o_pairs,
                            int o_blanket_ptr, int o_blanket_idx, void* trace, int N,
                            int S, int R, int H, int C, int maxp, int n_pairs,
                            int n_steps, uint64_t seed, int warps, void* stream) {
  if (C == 0 || n_steps == 0) return cudaSuccess;
  if (maxp < 1 || maxp > kMaxP) return cudaErrorInvalidValue;
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
  p.weights = static_cast<const double*>(weights);
  p.trace = static_cast<int16_t*>(trace);
  p.N = N; p.S = S; p.R = R; p.H = H; p.C = C; p.maxp = maxp;
  p.n_pairs = n_pairs; p.n_steps = n_steps; p.D = S * maxp * H + 3 * n_pairs;
  p.warps = warps; p.seed = seed;
  const size_t smem = (size_t)pedigree_sampler_smem_bytes(S, maxp, R) * warps;
  cudaError_t err = cudaFuncSetAttribute(
      pedigree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (C + warps - 1) / warps;
  pedigree_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
