// K2: the calling sampler for Hopper (sm_90a).
//
// Replaces mchap_tpu/ops/pallas_calling.py::pallas_calling_sampler (kernel
// body _make_kernel).  It computes the same Markov chain per chain: every
// ploidy slot starts at allele 0; each step sweeps the slots k = 0..P-1 in
// order and draws slot k from its flat-prior Gibbs conditional,
//   llks[h]   = sum_r counts[r] * (log(S_rest[r] + e[r][h]) + m[r] - log P)
//   logits[h] = llks[h] + log1p(copies of h among the other slots)
// with e[r][h] = exp(rh[r][h] - m[r]) and S_rest[r] the sum of the other
// slots' cached e, by Gumbel-max (ties to the lowest allele); the step
// records the sorted genotype and llks[choice] of the last slot.  The plain
// PyTorch version is mchap_tpu_torch/ops/cuda_calling.py::
// calling_sampler_plain, which adds in the same order.
//
// One fault of the TPU kernel is not copied: it pads the allele axis with
// 0.0 columns and takes the anchor m[r] over all columns, so m = 0 when H
// is not a multiple of 8, and a read below about -104 against every real
// haplotype underflows every real candidate to -inf and lets a padding
// allele win.  Here m[r] is the maximum over the problem's valid alleles
// (h < n_valid) only, and padding columns are never scored or chosen.
//
// What bounds it on this card: per chain-step it takes P*R*n_valid
// logarithms (one per slot, read and candidate) plus two per Gumbel draw,
// a sequence of P dependent slot updates per chain.  The logs run in the
// FP32 pipes (accurate logf, about 20 dependent instructions, which
// torch's log on the card repeats bit for bit); bytes are small (the
// per-problem e[R][H] is shared by all chains of a problem and stays in
// L1/L2).  At 65,536 chains the issue rate sets the time; at the shape of
// `mchap call`'s launch (440 problems x 2 chains, 16 distinct reads,
// panels of 6) the card holds about 7 warps per SM, and each slot's chain
// of dependent latencies does.
//
// Layout: one warp per chain, with the chain's (candidate, read) terms
// spread over all 32 lanes.  A chain whose problem has nv valid alleles
// takes nh = next_pow2(min(nv, 32)) candidates per pass and G = 32 / nh
// read groups: lane (j, hh) = j * nh + hh adds the terms of candidate
// hh (+ 32 per further pass when nv > 32) over the reads r = j, j + G,
// ... in order, and a xor butterfly over the G groups adds the partial
// sums pairwise (groups 2i and 2i+1 first), which leaves the same llk in
// every lane of the candidate.  So a panel of 16 fills the warp, and a
// panel of 6 over 16 reads gives each lane 4 terms, taken as one batch
// whose loads and logf overlap (a lane with more than 4 terms takes them
// one after another: where many warps hide the latency, fewer
// instructions per term win).  Per step the chain's uniform draws come
// from one Philox4x32-10 call per (slot, four candidates), all made by as
// many lanes during the step before (one slot at a time, in the slot,
// when P * ceil(nv / 4) > 32); each lane turns its call's four words
// into Gumbel terms, and a candidate's lane takes its term by shuffles.
// A warp arg-max by xor butterfly then leaves the same (score, allele,
// llk) in every lane, so the genotype lives in registers; log1p of the
// copies among the other slots comes from a table of P values.  Shared
// memory holds per read its (count, m - log P) pair, the chain's cached
// e of each slot and S_rest, which is rebuilt for the next slot where the
// chosen allele's e is cached (one __syncwarp per slot).  A prologue
// kernel computes the per-problem anchors m and exponentials e once per
// launch into scratch the wrapper allocates.  Draws: Philox4x32-10 with
// key (seed, chain_offset + chain) and counter (step, slot, h / 4,
// seed >> 32), word h % 4, or a pinned noise[T][P][H][C]; chain_offset
// is the launch's first chain in the whole block, so a block split over
// devices or processes draws what one launch of the whole block draws.
//
// The kernel's c is that index in the whole block, c in [chain_offset,
// chain_offset + C), so that the key takes no extra live register (adding
// the offset at each Philox call cost 1.5-3% per step in spills).  The
// per-chain arrays (problem, noise, alleles, llks) are therefore passed as
// integer addresses moved back by chain_offset elements (Params::*_at),
// and an element's address is formed as an integer, base + index *
// size, before it becomes a pointer (at<T>): every pointer the kernel
// forms lies inside its array, since index - chain_offset is the chain's
// index in the launch.  Invariant: chain_offset + C <= 2^31 - 1 (c is an
// int; the wrapper refuses more).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef K2_PROFILE  // mchap_tpu_torch/profile_k2.py defines MARK and PROF_ADD
#define PROF(...) __VA_ARGS__
#else
#define PROF(...)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoAllele = 0x7fffffff;

struct Params {
  const float* e;        // [S][R][H]  exp(rh - m), valid columns only
  const float* mlp;      // [S][R]     m - log P
  const float* counts;   // [S][R]
  const int* n_valid;    // [S]
  // per-chain arrays: integer addresses of element -chain_offset
  uintptr_t problem_at;  // int [C]
  uintptr_t noise_at;    // float [n_steps][P][H][C], or 0: Philox draws
  uintptr_t alleles_at;  // [n_steps][P][C], out_bytes each
  uintptr_t llks_at;     // float [n_steps][C]
  int S, R, H, C, n_steps, out_bytes, warps;
  uint64_t seed;
  uint32_t chain_offset;  // index of this launch's chain 0 in the whole block
};

// Element i of a per-chain array whose integer address ``base`` is that
// of element -chain_offset: the address is summed as an integer, and only
// the result, inside the array, becomes a pointer.
template <typename T>
__device__ __forceinline__ T* at(uintptr_t base, size_t i) {
  return reinterpret_cast<T*>(base + i * sizeof(T));
}

__device__ __forceinline__ void philox4(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1, uint32_t out[4]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t lo0 = c0 * 0xD2511F53u, hi0 = __umulhi(c0, 0xD2511F53u);
    uint32_t lo1 = c2 * 0xCD9E8D57u, hi1 = __umulhi(c2, 0xCD9E8D57u);
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// The Gumbel terms logf(-logf(u)) of candidates 4q .. 4q+3 of slot k.
template <int P>
__device__ __forceinline__ void gumbel4(const Params& p, int c, int step, int k, int q,
                                        float g[4]) {
  float u[4];
  if (p.noise_at) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int h = 4 * q + w;
      u[w] = h < p.H ? __ldg(at<const float>(p.noise_at,
                                               (((size_t)step * P + k) * p.H + h) * p.C + c))
                     : 0.5f;
    }
  } else {
    uint32_t bits[4];
    philox4((uint32_t)step, (uint32_t)k, (uint32_t)q, (uint32_t)(p.seed >> 32),
            (uint32_t)p.seed, (uint32_t)c, bits);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      u[w] = fmaxf((float)(bits[w] >> 9) * (1.0f / 8388608.0f), 1e-12f);
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) g[w] = logf(-logf(u[w]));
}

// Shared memory floats of one chain-warp: per read its (count, m - log P)
// pair, e per slot and S_rest, rounded up to whole pairs.
__host__ __device__ constexpr int64_t warp_floats(int P, int R) {
  return ((int64_t)(P + 3) * R + 1) & ~(int64_t)1;
}

// per (problem, read): the anchor over valid alleles, m - log P, and e
__global__ void anchor_kernel(const float* rh, const int* n_valid, float* e, float* mlp,
                              int S, int R, int H, float log_p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * R) return;
  const int nv = n_valid[i / R];
  const float* row = rh + (size_t)i * H;
  float m = row[0];
  for (int h = 1; h < nv; ++h) m = fmaxf(m, row[h]);
  float* erow = e + (size_t)i * H;
  for (int h = 0; h < H; ++h) erow[h] = h < nv ? expf(row[h] - m) : 0.f;
  mlp[i] = m - log_p;
}

// Candidate h's terms over this lane's reads r = j, j + G, ... (n of
// them), added in read order from 0.  Up to 4 reads go in one batch whose
// loads and logf are independent, so they overlap (lanes past n repeat
// read n - 1 and add nothing); more go one after another, which issues
// fewer instructions per term where many warps hide the latency.
__device__ __forceinline__ float read_terms(const float* srest, const float2* cm,
                                            const float* eh, int e_stride, int j, int G,
                                            int n) {
  float part = 0.f;
  if (n <= 0) return part;  // a read group past R
  if (n <= 4) {
    float x[4];
    float2 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(u, n - 1);
      const int r = j + i * G;
      q[u] = cm[r];
      x[u] = __fadd_rn(srest[r], __ldg(eh + i * e_stride));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float t = __fmul_rn(q[u].x, __fadd_rn(logf(x[u]), q[u].y));
      if (u < n) part = __fadd_rn(part, t);
    }
    return part;
  }
  const float* ep = eh;
#pragma unroll 4
  for (int r = j; r < j + n * G; r += G, ep += e_stride) {
    const float2 q = cm[r];
    const float t = logf(__fadd_rn(srest[r], __ldg(ep)));
    part = __fadd_rn(part, __fmul_rn(q.x, __fadd_rn(t, q.y)));
  }
  return part;
}

// S_rest of slot kn: the other slots' cached e, added in slot order, with
// slot k's new e (e_k) in place of its cached one
template <int P>
__device__ __forceinline__ float rest_sum(const float* es, int R, int r, int k, int kn,
                                          float e_k) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i == kn) continue;
    const float x = i == k ? e_k : es[i * R + r];
    acc = first ? x : __fadd_rn(acc, x);
    first = false;
  }
  return acc;
}

template <int P>
__global__ void __launch_bounds__(128) calling_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (int)p.chain_offset + blockIdx.x * p.warps + warp;
  if (c >= (int)p.chain_offset + p.C) return;  // whole warp leaves; there are no block barriers

  const int R = p.R, H = p.H;
  float2* cm = reinterpret_cast<float2*>(smem_raw) + (size_t)warp * warp_floats(P, R) / 2;
  float* es = reinterpret_cast<float*>(cm + R);  // [P][R] e of each slot's allele
  float* srest = es + P * R;                     // [R] S_rest of the current slot
  const int s = *at<const int>(p.problem_at, c);
  const float* e = p.e + (size_t)s * R * H;
  const int nv = p.n_valid[s];
  // lane (j, hh): candidate hh of each pass, reads r = j (mod G)
  int nh = 1;
  while (nh < nv && nh < 32) nh <<= 1;
  const int G = 32 / nh, hh = lane & (nh - 1), j = lane / nh;
  const int n_mine = j < R ? (R - 1 - j) / G + 1 : 0;  // reads of this lane's group
  // Philox calls per slot; all slots' calls at once when they fit the warp
  const int nq = (nv + 3) >> 2;
  const bool per_step = P * nq <= 32;
  // log1p of the copies among the other slots, 0 .. P-1
  float lp[P];
#pragma unroll
  for (int i = 0; i < P; ++i) lp[i] = log1pf((float)i);
  for (int r = lane; r < R; r += 32) {
    cm[r] = make_float2(__ldg(p.counts + (size_t)s * R + r), __ldg(p.mlp + (size_t)s * R + r));
    const float e0 = __ldg(e + (size_t)r * H);
#pragma unroll
    for (int k = 0; k < P; ++k) es[k * R + r] = e0;
    srest[r] = rest_sum<P>(es, R, r, -1, 0, 0.f);
  }
  __syncwarp();
  PROF(if (lane == 0) for (int i = 0; i < K2P_N; ++i) prof_s[warp][i] = 0;)

  int g[P];
#pragma unroll
  for (int k = 0; k < P; ++k) g[k] = 0;
  float gum_next[4] = {0.f, 0.f, 0.f, 0.f};
  if (per_step && lane < P * nq) gumbel4<P>(p, c, 0, lane / nq, lane % nq, gum_next);

#pragma unroll 1
  for (int step = 0; step < p.n_steps; ++step) {
    PROF(long long tm = clock64(); const long long t_step = tm;
         long long a_cand = 0, a_gum = 0, a_phi = 0, a_bfly = 0;)
    // lane L: call L's four Gumbel terms, made during the step before
    float gum4[4] = {gum_next[0], gum_next[1], gum_next[2], gum_next[3]};
    if (per_step && lane < P * nq && step + 1 < p.n_steps)
      gumbel4<P>(p, c, step + 1, lane / nq, lane % nq, gum_next);
    PROF(MARKR(a_phi))
    float llk = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      // each lane scores its candidate; best = max score, lowest allele
      float best_s = -INFINITY, best_l = 0.f;
      int best_h = kNoAllele;
      for (int c0 = 0; c0 < nv; c0 += 128) {
        if (!per_step) {
          if ((c0 >> 2) + lane < nq) gumbel4<P>(p, c, step, k, (c0 >> 2) + lane, gum4);
          PROF(MARKR(a_phi))
        }
        const int c1 = min(nv, c0 + 128);
        for (int hb = c0; hb < c1; hb += nh) {
          const int h = hb + hh;
          const bool valid = h < c1;
          // candidate h's Gumbel term, from the lane that made its call
          const int src = (per_step ? k * nq + (h >> 2) : (h - c0) >> 2) & 31;
          const float w0 = __shfl_sync(kFull, gum4[0], src);
          const float w1 = __shfl_sync(kFull, gum4[1], src);
          const float w2 = __shfl_sync(kFull, gum4[2], src);
          const float w3 = __shfl_sync(kFull, gum4[3], src);
          const int w = h & 3;
          const float gum = w == 0 ? w0 : w == 1 ? w1 : w == 2 ? w2 : w3;
          PROF(MARKR(a_phi))
          float part =
              valid ? read_terms(srest, cm, e + (size_t)j * H + h, G * H, j, G, n_mine) : 0.f;
          PROF(MARKR(a_cand))
          for (int o = nh; o < 32; o <<= 1)
            part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
          PROF(MARKR(a_bfly))
          if (valid) {
            int copies = 0;
#pragma unroll
            for (int i = 0; i < P; ++i) copies += (i != k) && (g[i] == h);
            float lc = lp[0];
#pragma unroll
            for (int i = 1; i < P; ++i) lc = copies == i ? lp[i] : lc;
            const float score = __fsub_rn(__fadd_rn(part, lc), gum);
            if (score > best_s || (score == best_s && h < best_h)) {
              best_s = score; best_h = h; best_l = part;
            }
          }
          PROF(MARKR(a_gum))
        }
      }
      // lanes of one candidate column agree, so the columns' bits suffice
      for (int o = 1; o < nh; o <<= 1) {
        const float os = __shfl_xor_sync(kFull, best_s, o);
        const int oh = __shfl_xor_sync(kFull, best_h, o);
        const float ol = __shfl_xor_sync(kFull, best_l, o);
        if (os > best_s || (os == best_s && oh < best_h)) {
          best_s = os; best_h = oh; best_l = ol;
        }
      }
      if (best_h == kNoAllele) best_h = 0;  // every score NaN: keep in bounds
      PROF(MARKR(a_bfly))
      g[k] = best_h;
      llk = best_l;
      // the chosen allele's e into slot k's cache, and the next slot's S_rest
      __syncwarp();  // every lane has read this slot's S_rest
      const int kn = k + 1 < P ? k + 1 : 0;
      for (int r = lane; r < R; r += 32) {
        const float e_k = __ldg(e + (size_t)r * H + best_h);
        srest[r] = rest_sum<P>(es, R, r, k, kn, e_k);
        es[k * R + r] = e_k;
      }
      __syncwarp();
      PROF(MARK(5))
    }
    PROF(PROF_ADD(1, a_cand) PROF_ADD(2, a_gum) PROF_ADD(3, a_phi) PROF_ADD(4, a_bfly)
         tm = clock64();)

    // trace: the sorted genotype and the last slot's llk
    int sorted[P];
#pragma unroll
    for (int k = 0; k < P; ++k) sorted[k] = g[k];
#pragma unroll
    for (int i = 1; i < P; ++i) {
#pragma unroll
      for (int jj = i; jj > 0; --jj) {
        const int a = sorted[jj - 1], b = sorted[jj];
        sorted[jj - 1] = min(a, b);
        sorted[jj] = max(a, b);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (lane == k) {
        const size_t o = ((size_t)step * P + k) * p.C + c;
        if (p.out_bytes == 1) *at<int8_t>(p.alleles_at, o) = (int8_t)sorted[k];
        else *at<int16_t>(p.alleles_at, o) = (int16_t)sorted[k];
      }
    }
    if (lane == 0) *at<float>(p.llks_at, (size_t)step * p.C + c) = llk;
    PROF(MARK(6) PROF_ADD(7, clock64() - t_step))
  }
  PROF(if (lane == 0) for (int i = 0; i < K2P_N; ++i) atomicAdd(&g_prof[i], prof_s[warp][i]);)
}

template <int P>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)warp_floats(P, p.R) * sizeof(float) * p.warps;
  cudaError_t err = cudaFuncSetAttribute(
      calling_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.C + p.warps - 1) / p.warps;
  calling_kernel<P><<<blocks, 32 * p.warps, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one chain-warp needs: (count, m - log P) per read, e per
// slot and S_rest.
int64_t calling_sampler_smem_bytes(int P, int R) { return warp_floats(P, R) * 4; }

const char* calling_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int calling_sampler_launch(const void* rh, const void* counts, const void* n_valid,
                           const void* problem, const void* noise, void* e_scratch,
                           void* mlp_scratch, void* alleles, void* llks, int S, int R,
                           int H, int P, int C, int n_steps, float log_p, int out_bytes,
                           uint64_t seed, uint32_t chain_offset, int warps,
                           void* stream) {
  if (C == 0 || n_steps == 0) return cudaSuccess;
  if ((uint64_t)chain_offset + (uint64_t)C > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = S * R;
  anchor_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(rh), static_cast<const int*>(n_valid),
      static_cast<float*>(e_scratch), static_cast<float*>(mlp_scratch), S, R, H, log_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params p;
  // per-chain arrays: the integer address of element -chain_offset (see
  // the note at the top; unsigned arithmetic, so no pointer leaves its array)
  const uintptr_t back = (uintptr_t)chain_offset;
  p.e = static_cast<const float*>(e_scratch);
  p.mlp = static_cast<const float*>(mlp_scratch);
  p.counts = static_cast<const float*>(counts);
  p.n_valid = static_cast<const int*>(n_valid);
  p.problem_at = reinterpret_cast<uintptr_t>(problem) - back * sizeof(int);
  p.noise_at = noise ? reinterpret_cast<uintptr_t>(noise) - back * sizeof(float) : 0;
  p.alleles_at = reinterpret_cast<uintptr_t>(alleles) - back * out_bytes;
  p.llks_at = reinterpret_cast<uintptr_t>(llks) - back * sizeof(float);
  p.S = S; p.R = R; p.H = H; p.C = C; p.n_steps = n_steps;
  p.out_bytes = out_bytes; p.warps = warps; p.seed = seed;
  p.chain_offset = chain_offset;
  switch (P) {
    case 1: return launch_p<1>(p, st);
    case 2: return launch_p<2>(p, st);
    case 3: return launch_p<3>(p, st);
    case 4: return launch_p<4>(p, st);
    case 5: return launch_p<5>(p, st);
    case 6: return launch_p<6>(p, st);
    case 7: return launch_p<7>(p, st);
    case 8: return launch_p<8>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
