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
// What bounds it on this card: per chain-step it takes P*R*H logarithms
// (one per slot, read and candidate) plus two per Gumbel draw, a sequence
// of dependent slot updates per chain.  The logs run in the FP32/SFU pipes;
// bytes are small (the per-problem e[R][H] is shared by all chains of a
// problem and stays in L1/L2).
//
// Layout: one warp per chain.  The warp first writes S_rest[r] into shared
// memory (lanes stride over reads), then lane h (h += 32 when H > 32) sums
// its candidate over the reads in order, so every candidate's llk is one
// sequential f32 sum that the plain version repeats exactly; a warp
// arg-max by xor butterfly leaves the same (score, allele, llk) in every
// lane, so the genotype lives in registers and no broadcast is needed.
// The chain's cached e for each slot, the read counts and m - log P sit in
// shared memory.  A prologue kernel computes the per-problem anchors m and
// exponentials e once per launch into scratch the wrapper allocates.
// Uniform draws come from Philox4x32-10 with key (seed, chain) and counter
// (step, slot, h / 4, seed >> 32), or from a pinned noise[T][P][H][C].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoAllele = 0x7fffffff;

struct Params {
  const float* e;        // [S][R][H]  exp(rh - m), valid columns only
  const float* mlp;      // [S][R]     m - log P
  const float* counts;   // [S][R]
  const int* n_valid;    // [S]
  const int* problem;    // [C]
  const float* noise;    // [n_steps][P][H][C] or null
  void* alleles;         // [n_steps][P][C], out_bytes each
  float* llks;           // [n_steps][C]
  int S, R, H, C, n_steps, out_bytes, warps;
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

template <int P>
__device__ __forceinline__ float uniform(const Params& p, int c, int step, int k, int h) {
  if (p.noise)
    return __ldg(p.noise + (((size_t)step * P + k) * p.H + h) * p.C + c);
  const uint32_t bits =
      philox_word((uint32_t)step, (uint32_t)k, (uint32_t)(h >> 2),
                  (uint32_t)(p.seed >> 32), (uint32_t)p.seed, (uint32_t)c, h & 3);
  return fmaxf((float)(bits >> 9) * (1.0f / 8388608.0f), 1e-12f);
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

template <int P>
__global__ void __launch_bounds__(128) calling_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * p.warps + warp;
  if (c >= p.C) return;  // whole warp leaves; there are no block barriers

  const int R = p.R, H = p.H;
  float* es = smem + (size_t)warp * (P + 3) * R;  // [P][R] e of each slot's allele
  float* srest = es + P * R;                      // [R]
  float* cnt = srest + R;                         // [R]
  float* mlp = cnt + R;                           // [R]
  const int s = p.problem[c];
  const float* e = p.e + (size_t)s * R * H;
  const int nv = p.n_valid[s];
  for (int r = lane; r < R; r += 32) {
    cnt[r] = __ldg(p.counts + (size_t)s * R + r);
    mlp[r] = __ldg(p.mlp + (size_t)s * R + r);
    const float e0 = __ldg(e + (size_t)r * H);
#pragma unroll
    for (int k = 0; k < P; ++k) es[k * R + r] = e0;
  }
  __syncwarp();

  int g[P];
#pragma unroll
  for (int k = 0; k < P; ++k) g[k] = 0;

#pragma unroll 1
  for (int step = 0; step < p.n_steps; ++step) {
    float llk = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      // S_rest: the other slots' cached e, added in slot order
      for (int r = lane; r < R; r += 32) {
        float acc = 0.f;
        bool first = true;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i == k) continue;
          acc = first ? es[i * R + r] : __fadd_rn(acc, es[i * R + r]);
          first = false;
        }
        srest[r] = acc;
      }
      __syncwarp();

      // each lane scores its candidates; best = max score, lowest allele
      float best_s = -INFINITY, best_l = 0.f;
      int best_h = kNoAllele;
      for (int h = lane; h < nv; h += 32) {
        float l = 0.f;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const float t = logf(__fadd_rn(srest[r], __ldg(e + (size_t)r * H + h)));
          l = __fadd_rn(l, __fmul_rn(cnt[r], __fadd_rn(t, mlp[r])));
        }
        int copies = 0;
#pragma unroll
        for (int i = 0; i < P; ++i) copies += (i != k) && (g[i] == h);
        const float logit = __fadd_rn(l, log1pf((float)copies));
        const float u = uniform<P>(p, c, step, k, h);
        const float score = __fsub_rn(logit, logf(-logf(u)));
        if (score > best_s || (score == best_s && h < best_h)) {
          best_s = score; best_h = h; best_l = l;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_xor_sync(kFull, best_s, o);
        const int oh = __shfl_xor_sync(kFull, best_h, o);
        const float ol = __shfl_xor_sync(kFull, best_l, o);
        if (os > best_s || (os == best_s && oh < best_h)) {
          best_s = os; best_h = oh; best_l = ol;
        }
      }
      if (best_h == kNoAllele) best_h = 0;  // every score NaN: keep in bounds
      g[k] = best_h;
      llk = best_l;
      for (int r = lane; r < R; r += 32) es[k * R + r] = __ldg(e + (size_t)r * H + best_h);
      __syncwarp();
    }

    // trace: the sorted genotype and the last slot's llk
    int sorted[P];
#pragma unroll
    for (int k = 0; k < P; ++k) sorted[k] = g[k];
#pragma unroll
    for (int i = 1; i < P; ++i) {
#pragma unroll
      for (int j = i; j > 0; --j) {
        const int a = sorted[j - 1], b = sorted[j];
        sorted[j - 1] = min(a, b);
        sorted[j] = max(a, b);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (lane == k) {
        const size_t o = ((size_t)step * P + k) * p.C + c;
        if (p.out_bytes == 1) static_cast<int8_t*>(p.alleles)[o] = (int8_t)sorted[k];
        else static_cast<int16_t*>(p.alleles)[o] = (int16_t)sorted[k];
      }
    }
    if (lane == 0) p.llks[(size_t)step * p.C + c] = llk;
  }
}

template <int P>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(P + 3) * p.R * sizeof(float) * p.warps;
  cudaError_t err = cudaFuncSetAttribute(
      calling_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.C + p.warps - 1) / p.warps;
  calling_kernel<P><<<blocks, 32 * p.warps, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one chain-warp needs: e per slot, S_rest, counts, m - log P.
int64_t calling_sampler_smem_bytes(int P, int R) { return (int64_t)(P + 3) * R * 4; }

const char* calling_sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int calling_sampler_launch(const void* rh, const void* counts, const void* n_valid,
                           const void* problem, const void* noise, void* e_scratch,
                           void* mlp_scratch, void* alleles, void* llks, int S, int R,
                           int H, int P, int C, int n_steps, float log_p, int out_bytes,
                           uint64_t seed, int warps, void* stream) {
  if (C == 0 || n_steps == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = S * R;
  anchor_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(rh), static_cast<const int*>(n_valid),
      static_cast<float*>(e_scratch), static_cast<float*>(mlp_scratch), S, R, H, log_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params p;
  p.e = static_cast<const float*>(e_scratch);
  p.mlp = static_cast<const float*>(mlp_scratch);
  p.counts = static_cast<const float*>(counts);
  p.n_valid = static_cast<const int*>(n_valid);
  p.problem = static_cast<const int*>(problem);
  p.noise = static_cast<const float*>(noise);
  p.alleles = alleles;
  p.llks = static_cast<float*>(llks);
  p.S = S; p.R = R; p.H = H; p.C = C; p.n_steps = n_steps;
  p.out_bytes = out_bytes; p.warps = warps; p.seed = seed;
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
