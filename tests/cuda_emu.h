// Host emulation of the CUDA subset that the port's sampler kernels use,
// so that a kernel source can be compiled with g++ and run on the CPU
// (tests/test_torch_denovo_emulated.py).  Every GPU thread is a fiber on
// one OS thread, switched by a few lines of x86-64 assembly; warp
// shuffles, ballots, __reduce_*_sync, __syncwarp, __syncthreads and
// bar.sync are barriers that switch fibers.  Blocks run one after
// another.  Not emulated: the order in which a real card interleaves
// warps, so a race between warps shows only on the card.  Float
// arithmetic is the host's (build with -ffp-contract=off); expf, logf
// and log1pf may differ from the card's in the last bit.
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <math.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>
#include <functional>
#include <map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n)
#define __restrict__

struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMemoryAllocation = 2,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace emu {
struct Fiber {
  void* sp = nullptr;
  char* stack = nullptr;
  dim3 tid;
  bool done = false;
  int wait_kind = 0;  // 0 runnable, 1 warp barrier, 2 named barrier
  int wait_id = 0;
  unsigned wait_gen = 0;
};
struct Bar { int count = 0; unsigned gen = 0; };
struct Block {
  std::vector<Fiber> f;
  std::vector<Bar> warp_bar;
  std::map<int, Bar> named;
  std::vector<uint64_t> xbuf;  // per thread exchange slot
  std::vector<unsigned char> smem;
  dim3 bid;
  dim3 bdim;
  std::function<void()> body;
};
extern Block* g_block;
extern int g_cur;
extern void* g_main_sp;
}  // namespace emu

extern "C" void emu_switch(void** save_sp, void* new_sp);

inline emu::Fiber& emu_self() { return emu::g_block->f[emu::g_cur]; }
#define threadIdx (emu_self().tid)
#define blockIdx (emu::g_block->bid)
#define blockDim (emu::g_block->bdim)

inline void emu_yield() { emu_switch(&emu_self().sp, emu::g_main_sp); }

inline void emu_warp_barrier() {
  auto& b = *emu::g_block;
  const int w = emu::g_cur / 32;
  // active lanes of the warp: those not done
  int active = 0;
  for (int l = 0; l < 32 && w * 32 + l < (int)b.f.size(); ++l) active += !b.f[w * 32 + l].done;
  emu::Bar& bar = b.warp_bar[w];
  if (++bar.count == active) { bar.count = 0; bar.gen++; return; }
  emu_self().wait_kind = 1; emu_self().wait_id = w; emu_self().wait_gen = bar.gen;
  emu_yield();
}

inline void emu_bar_sync(int id, int n) {
  auto& b = *emu::g_block;
  emu::Bar& bar = b.named[id];
  if (++bar.count == n) { bar.count = 0; bar.gen++; return; }
  emu_self().wait_kind = 2; emu_self().wait_id = id; emu_self().wait_gen = bar.gen;
  emu_yield();
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barrier(); }
inline void __syncthreads() { emu_bar_sync(0, (int)emu::g_block->f.size()); }

template <class T> T emu_exchange(T v, int src_lane) {
  auto& b = *emu::g_block;
  uint64_t x = 0; memcpy(&x, &v, sizeof(T));
  b.xbuf[emu::g_cur] = x;
  emu_warp_barrier();
  const int w = emu::g_cur / 32;
  uint64_t y = b.xbuf[w * 32 + (src_lane & 31)];
  emu_warp_barrier();
  T r; memcpy(&r, &y, sizeof(T));
  return r;
}
inline int emu_lane() { return emu::g_cur & 31; }
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return emu_exchange(v, emu_lane() ^ o); }
template <class T> T __shfl_sync(unsigned, T v, int s, int width = 32) {
  return emu_exchange(v, (emu_lane() & ~(width - 1)) + (s & (width - 1)));
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int l = emu_lane();
  T r = emu_exchange(v, l >= d ? l - d : l);
  return r;
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) {
  const int l = emu_lane();
  return emu_exchange(v, l + d < 32 ? l + d : l);
}
template <class F> uint64_t emu_reduce(uint64_t v, F op) {
  auto& b = *emu::g_block;
  b.xbuf[emu::g_cur] = v;
  emu_warp_barrier();
  const int w = emu::g_cur / 32;
  uint64_t acc = 0; bool first = true;
  for (int l = 0; l < 32 && w * 32 + l < (int)b.f.size(); ++l) {
    if (b.f[w * 32 + l].done) continue;
    acc = first ? b.xbuf[w * 32 + l] : op(acc, b.xbuf[w * 32 + l]);
    first = false;
  }
  emu_warp_barrier();
  return acc;
}
inline unsigned __ballot_sync(unsigned, int p) {
  auto& b = *emu::g_block;
  b.xbuf[emu::g_cur] = p ? 1 : 0;
  emu_warp_barrier();
  const int w = emu::g_cur / 32;
  unsigned m = 0;
  for (int l = 0; l < 32 && w * 32 + l < (int)b.f.size(); ++l)
    if (!b.f[w * 32 + l].done && b.xbuf[w * 32 + l]) m |= 1u << l;
  emu_warp_barrier();
  return m;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) { return __ballot_sync(m, !p) == 0; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)emu_reduce(v, [](uint64_t a, uint64_t b) { return a | b; });
}
inline unsigned __reduce_and_sync(unsigned, unsigned v) {
  return (unsigned)emu_reduce(v, [](uint64_t a, uint64_t b) { return a & b; });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return (unsigned)emu_reduce(v, [](uint64_t a, uint64_t b) { return (uint64_t)(unsigned)(a + b); });
}
inline int __reduce_add_sync(unsigned m, int v) { return (int)__reduce_add_sync(m, (unsigned)v); }
inline int __reduce_max_sync(unsigned, int v) {
  return (int)(int32_t)emu_reduce((uint64_t)(uint32_t)v, [](uint64_t a, uint64_t b) {
    return (int32_t)a > (int32_t)b ? a : b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)(int32_t)emu_reduce((uint64_t)(uint32_t)v, [](uint64_t a, uint64_t b) {
    return (int32_t)a < (int32_t)b ? a : b; });
}

template <class T> T __ldg(const T* p) { return *p; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __ffsll(unsigned long long x) { return __builtin_ffsll((long long)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __brev(unsigned x) { unsigned r = 0; for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i); return r; }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((uint64_t)a * b) >> 32); }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline long long clock64() { return 0; }
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
template <class T> T min(T a, T b) { return a < b ? a : b; }
template <class T> T max(T a, T b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "emu error" : "no error"; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaDeviceSynchronize() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t = 0) { memset(p, v, n); return 0; }
template <class T> cudaError_t cudaMemcpyFromSymbol(void* d, const T& s, size_t n) { memcpy(d, &s, n); return 0; }
template <class T> cudaError_t cudaMemcpyToSymbol(T& s, const void* d, size_t n) { memcpy(&s, d, n); return 0; }


// ---- runtime (one translation unit) ----

namespace emu {
Block* g_block = nullptr;
int g_cur = 0;
void* g_main_sp = nullptr;
}  // namespace emu

asm(R"(
.text
.globl emu_switch
.type emu_switch,@function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
)");

static void emu_trampoline() {
  emu::g_block->body();
  emu_self().done = true;
  emu_yield();
  abort();  // never resumed
}

unsigned char* emu_dyn_smem() { return emu::g_block->smem.data(); }

static const size_t kStack = 256 * 1024;

int emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> body) {
  const int nt = block.x * block.y * block.z;
  const long nb = (long)grid.x * grid.y * grid.z;
  std::vector<char*> stacks(nt);
  for (int t = 0; t < nt; ++t) stacks[t] = (char*)aligned_alloc(64, kStack);
  for (long bi = 0; bi < nb; ++bi) {
    emu::Block b;
    b.f.resize(nt);
    b.warp_bar.resize((nt + 31) / 32);
    b.xbuf.assign(nt, 0);
    b.smem.assign(smem + 16, 0xA5);  // garbage, as on the card
    b.bid = dim3((unsigned)bi);
    b.bdim = block;
    b.body = body;
    for (int t = 0; t < nt; ++t) {
      auto& f = b.f[t];
      f.tid = dim3(t);
      f.stack = stacks[t];
      uintptr_t top = ((uintptr_t)(f.stack + kStack)) & ~(uintptr_t)15;
      uint64_t* sp = (uint64_t*)top;
      *--sp = 0;                          // pad: rsp % 16 == 8 at entry
      *--sp = (uint64_t)&emu_trampoline;  // popped by ret
      for (int i = 0; i < 6; ++i) *--sp = 0;
      f.sp = sp;
    }
    emu::g_block = &b;
    int n_done = 0;
    while (n_done < nt) {
      bool progress = false;
      n_done = 0;
      for (int t = 0; t < nt; ++t) {
        auto& f = b.f[t];
        if (f.done) { ++n_done; continue; }
        if (f.wait_kind == 1 && b.warp_bar[f.wait_id].gen == f.wait_gen) continue;
        if (f.wait_kind == 2 && b.named[f.wait_id].gen == f.wait_gen) continue;
        f.wait_kind = 0;
        emu::g_cur = t;
        emu_switch(&emu::g_main_sp, f.sp);
        progress = true;
        if (f.done) ++n_done;
      }
      if (!progress && n_done < nt) {
        // a warp barrier may complete because lanes finished
        bool fixed = false;
        for (size_t w = 0; w < b.warp_bar.size(); ++w) {
          int active = 0, waiting = 0;
          for (int l = 0; l < 32 && (int)w * 32 + l < nt; ++l) {
            auto& f = b.f[w * 32 + l];
            active += !f.done;
            waiting += !f.done && f.wait_kind == 1;
          }
          if (waiting && waiting == active && b.warp_bar[w].count == active) {
            b.warp_bar[w].count = 0; b.warp_bar[w].gen++; fixed = true;
          }
        }
        if (!fixed) {
          fprintf(stderr, "emu: deadlock in block %ld\n", bi);
          for (int t = 0; t < nt; ++t)
            fprintf(stderr, "  t%d done %d wait %d/%d\n", t, b.f[t].done, b.f[t].wait_kind, b.f[t].wait_id);
          abort();
        }
      }
    }
    emu::g_block = nullptr;
  }
  for (auto s : stacks) free(s);
  return 0;
}
