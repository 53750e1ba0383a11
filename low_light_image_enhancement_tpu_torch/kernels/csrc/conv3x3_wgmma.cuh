// K6's bf16 form on the tensor cores: one 3x3 conv layer as an implicit
// GEMM of wgmma (sm_90a) fed by TMA. mxu_conv.cu launches it for bf16;
// the f32 form and K7 keep conv3x3.cuh on the CUDA cores.
//
// The GEMM. M = output pixels: one wgmma M tile is 64 consecutive x of
// one output row. N = Cout (m64nNk16, N = 8, 16, 24 or 32). K = 9 taps x
// Cin in k16 steps, walked tap-major, then piece by piece (below), 16
// channels a step. The bf16 products sum in f32 registers; the epilogue
// adds the f32 bias, applies the activation in f32 and casts once to bf16
// (the contract of kernels/mxu_conv.py).
//
// Pieces. Each input group (the skip concat's two tensors are two groups,
// each read in place through its own tensor map) is cut into pieces of
// CP = 16, 32 or 64 channels (64 where the group is wider), so that one
// pixel of a piece is one 32-, 64- or 128-byte row, the width of a TMA /
// wgmma swizzle. Channels past the group's width (Cin 24 in a 32-channel
// piece) are zeros from TMA's out-of-bounds fill, against zero weight
// rows: the k16 padding costs no code.
//
// A operand: pixel-major, swizzled, in a ring of halo rows. A block walks
// strips: 64 x of up to STRIP_ROWS output rows of one image and one
// dilation phase (rows y0, y0 + d, ...), so that the three taps of a
// column fall on rows of the same strip at any d. Down a strip it loads
// each input row once, per piece one TMA box (CP channels, X pixels, 1
// row, 1 image) of the NHWC tensor, X * CP * 2 contiguous bytes, swizzled
// on the way in (16-byte chunks XORed by the row, so the 8 rows a wgmma
// core matrix reads lie in 8 banks), into the next slot of a ring of
// halo rows. A group of ROWS output rows reads ROWS + 2 slots; the A
// operand of tap (dy, dx) and output row k is the K-major swizzled
// descriptor of slot k + dy with its start moved by dx * d pixels, and by
// 32 bytes a k16 step. TMA fills what lies outside the tensor with zeros,
// which is conv-SAME padding, so no code handles edges. Each input row
// serves the two groups that overlap on it; its slot's empty barrier
// counts both (a row that only one group reads counts twice from it).
//
// Dilation. Along x the box is 64 + 2d pixels (rounded up to 8), the three
// dx taps being offsets into it, while that fits 192 (d <= 64; fcn's d 32
// loads 128 for 64 outputs); beyond, each row is three 64-pixel boxes, one
// per dx.
//
// B operand: the packed bf16 weights (mxu_conv.py pack_conv_weights_wgmma),
// for each tap and piece a Cout x CP K-major matrix in the piece's swizzle,
// each 1024-byte aligned; copied once into shared memory per persistent
// block.
//
// The pipeline. One producer thread issues the TMA loads of the halo rows
// in order; two consumer warpgroups take the row groups in turn, so one's
// epilogue overlaps the other's wgmma. The first wgmma of a group writes
// the accumulators (scale-d 0), and the warp roles are read through a
// shuffle, so that ptxas sees no register defined outside wgmma and no
// divergent path between them: otherwise it serializes the wgmma (ptxas
// C7520). The nets' layers, one or two 64-byte pieces, run a kernel that
// names its pieces at compile time, every descriptor a base plus a
// constant; other widths walk their pieces at run time, more slowly.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // driver at run time (cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace llie {
namespace wgmma_conv {

constexpr int TILE_X = 64;           // pixels of one wgmma M tile
constexpr int ROWS = 2;              // output rows of a group
constexpr int STRIP_ROWS = 32;       // output rows of a strip
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory of a block
constexpr int MAX_BOX_X = 192;       // the widest contiguous halo row
constexpr int MAX_PIECES = 8;        // Cin <= 512
constexpr int MAX_SLOTS = 16;        // halo rows in the ring
constexpr uint32_t ALIGN = 1024;     // the 128-byte swizzle's period

// One piece of an input group: CP channels from channel c0 of group `map`.
struct Piece {
  int map, c0, ksteps;  // ksteps = CP / 16
  uint32_t sp;          // bytes a pixel: 2 * CP = the swizzle width
  uint32_t aoff;        // its region in a halo row (per dx box if nseg 3)
  uint32_t areg;        // bytes of one such region
  uint32_t woff;        // its weights within a tap
};

// The layer's geometry, computed on the host (plan()).
struct Geom {
  int B, H, W, dil, act;
  int phases, chunks, xtiles;  // strips: B * phases * chunks * xtiles
  int nstrips;
  int slots;            // halo rows in the ring
  int nseg, box_x;      // boxes a halo row (1 or 3) and their pixels
  int npieces;
  Piece pc[MAX_PIECES];
  uint32_t row;         // bytes of one halo row (all pieces)
  uint32_t tx_bytes;    // bytes TMA delivers into a halo row
  uint32_t wtap;        // bytes of one tap's weights
  uint32_t w_bytes;     // bytes of the packed weights (9 taps)
  int smem;             // dynamic shared memory to ask for
};

inline __device__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

inline __device__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

inline __device__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

inline __device__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Returns once the phase of parity `parity` has completed (a fresh
// barrier counts the phase before its first as completed with parity 1).
// The loop is inside the asm, as in CUTLASS, so that it is no branch of
// the kernel's control flow.
inline __device__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

inline __device__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                 uint32_t bar, int c0, int c1, int c2,
                                 int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A K-major swizzled shared-memory matrix descriptor: rows of `sp` bytes
// (32, 64 or 128, the swizzle width), 8-row groups at SBO = 8 * sp, base
// offset 0. The hardware swizzles on the address itself (bits 4-6 XOR bits
// 7-9), as TMA does, so a start moved by whole rows or by 32 bytes within
// a row reads what TMA wrote; a base offset of (start >> 7) & 7 shifts the
// pattern and reads wrong values (found on the H100).
inline __device__ uint64_t mat_desc(uint32_t addr, uint32_t sp) {
  const uint64_t layout = sp == 128 ? 1 : sp == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * sp) >> 4) << 32) | (layout << 62);
}

inline __device__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
inline __device__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
inline __device__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d += A * B (scale_d 1) or d = A * B (scale_d 0), both operands K-major
// in shared memory, bf16 in, f32 accumulators.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ void run(float (&d)[4], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ void run(float (&d)[8], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<24> {
  static __device__ void run(float (&d)[12], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, "
        "1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ void run(float (&d)[16], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
inline __device__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

struct Strip {
  int b, y0, x0;  // output rows y0 + i * dil, i < nrows (those below H)
  int groups;     // row groups of ROWS; it loads ROWS * groups + 2 rows
  bool live;      // false for the empty last chunks of short phases
};

// Strip t, ordered (image, phase, chunk, x tile), x fastest.
inline __device__ Strip strip_at(const Geom& g, int t) {
  Strip s;
  const int xt = t % g.xtiles;
  t /= g.xtiles;
  const int c = t % g.chunks;
  t /= g.chunks;
  const int p = t % g.phases;
  s.b = t / g.phases;
  s.x0 = xt * TILE_X;
  const int n = (g.H - p + g.dil - 1) / g.dil - c * STRIP_ROWS;
  s.live = n > 0;
  s.groups = (min(n, STRIP_ROWS) + ROWS - 1) / ROWS;
  s.y0 = p + c * STRIP_ROWS * g.dil;
  return s;
}

// How many of a strip's `groups` row groups read its halo row j (group q
// reads rows q * ROWS ... q * ROWS + ROWS + 1): 1 or 2.
inline __device__ uint32_t readers(int j, int groups) {
  const int hi = min(groups - 1, j / ROWS);
  const int lo = j <= ROWS + 1 ? 0 : (j - 2) / ROWS;
  return (uint32_t)(hi - lo + 1);
}

// The wgmma of one row group: 9 taps x the pieces x their k16 steps x
// ROWS output rows, the first writing the accumulators. SP and NP > 0 name
// the pieces at compile time (NP pieces of SP bytes a pixel), so that
// every descriptor is a base plus a constant; 0 reads them from g.
template <int N, int SP, int NP>
inline __device__ void group_mma(float (&acc)[ROWS][N / 2], const Geom& g,
                                 uint32_t ring,
                                 const uint32_t (&slot)[ROWS + 2],
                                 uint32_t sw) {
  if constexpr (NP > 0) {
    constexpr uint32_t WP = (N * SP + ALIGN - 1) / ALIGN * ALIGN;
    constexpr int KS = SP / 32;
    const uint32_t dxb = g.nseg == 1 ? g.dil * SP : g.pc[0].areg;
    const uint32_t pstep = NP > 1 ? g.pc[1].aoff : 0;
    uint64_t a[ROWS + 2];
#pragma unroll
    for (int j = 0; j < ROWS + 2; ++j)
      a[j] = mat_desc(ring + slot[j] * g.row, SP);
    const uint64_t b = mat_desc(sw, SP);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint64_t db = b + ((tap * NP * WP + p * WP + 32 * kk) >> 4);
          const uint32_t off = (p * pstep + dx * dxb + 32 * kk) >> 4;
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            Mma<N>::run(acc[k], a[k + dy] + off, db, (tap | p | kk) != 0);
        }
    }
  } else {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
      for (int p = 0; p < g.npieces; ++p) {
        const Piece& pc = g.pc[p];
        const uint32_t a_dx =
            pc.aoff + (g.nseg == 1 ? dx * g.dil * pc.sp : dx * pc.areg);
        const uint32_t b0 = sw + tap * g.wtap + pc.woff;
#pragma unroll 1
        for (int kk = 0; kk < pc.ksteps; ++kk) {
          const uint64_t db = mat_desc(b0 + 32 * kk, pc.sp);
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            Mma<N>::run(acc[k],
                        mat_desc(ring + slot[k + dy] * g.row + a_dx + 32 * kk,
                                 pc.sp),
                        db, (tap | p | kk) != 0);
        }
      }
    }
  }
}

template <int N, int SP, int NP>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out,
                     const __grid_constant__ Geom g) {
  extern __shared__ unsigned char smem_raw[];
  // [weights][slots x row][full x slots][empty x slots], from the first
  // ALIGN boundary of the dynamic shared memory
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1);
  const uint32_t sw = raw + pad;
  const uint32_t ring = sw + g.w_bytes;
  const uint32_t full0 = ring + g.slots * g.row;
  const uint32_t empty0 = full0 + 8 * g.slots;
  {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    uint4* dst = reinterpret_cast<uint4*>(smem_raw + pad);
    for (uint32_t i = threadIdx.x; i < g.w_bytes / 16; i += THREADS)
      dst[i] = src[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the weights' generic-proxy writes, visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // the producer: one thread loads the halo rows in order
    if (threadIdx.x % 128 != 0) return;
    uint32_t rc = 0;  // rows issued
    for (int t = blockIdx.x; t < g.nstrips; t += gridDim.x) {
      const Strip sp = strip_at(g, t);
      if (!sp.live) continue;
#pragma unroll 1
      for (int j = 0; j < ROWS * sp.groups + 2; ++j, ++rc) {
        const uint32_t s = rc % g.slots;
        mbar_wait(empty0 + 8 * s, ((rc / g.slots) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, g.tx_bytes);
        const int y = sp.y0 + (j - 1) * g.dil;
#pragma unroll 1
        for (int p = 0; p < g.npieces; ++p) {
          const Piece& pc = g.pc[p];
          const CUtensorMap* map = pc.map ? &map_b : &map_a;
#pragma unroll 1
          for (int k = 0; k < g.nseg; ++k) {
            const int x =
                g.nseg == 1 ? sp.x0 - g.dil : sp.x0 + (k - 1) * g.dil;
            tma_load4(ring + s * g.row + pc.aoff + k * pc.areg, map, bar,
                      pc.c0, x, y, sp.b);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: row groups qc = wg, wg + CONSUMERS, ... of this
  // block
  const int wtid = threadIdx.x % 128;
  const int m0 = (wtid / 32) * 16 + (wtid % 32) / 4;  // rows m0, m0 + 8
  const int c0 = 2 * (wtid % 4);  // channels c0, c0 + 1 of each 8
  float bv[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bv[2 * j] = bias[8 * j + c0];
    bv[2 * j + 1] = bias[8 * j + c0 + 1];
  }
  uint32_t rc = 0;  // the first halo row of the strip, in issue order
  int qc = 0;       // row groups of this block so far
  for (int t = blockIdx.x; t < g.nstrips; t += gridDim.x) {
    const Strip sp = strip_at(g, t);
    if (!sp.live) continue;
#pragma unroll 1
    for (int q = 0; q < sp.groups; ++q, ++qc) {
      if (qc % CONSUMERS != wg) continue;
      uint32_t slot[ROWS + 2];
#pragma unroll
      for (int j = 0; j < ROWS + 2; ++j) {
        const uint32_t r = rc + q * ROWS + j;
        slot[j] = r % g.slots;
        mbar_wait(full0 + 8 * slot[j], (r / g.slots) & 1);
      }
      float acc[ROWS][N / 2];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
      wgmma_fence();
      group_mma<N, SP, NP>(acc, g, ring, slot, sw);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
      // the group's rows are read: one arrival for each, two where it is
      // the row's only reader
      if (wtid == 0) {
#pragma unroll
        for (int j = 0; j < ROWS + 2; ++j)
          mbar_arrive(empty0 + 8 * slot[j],
                      3 - readers(q * ROWS + j, sp.groups));
      }

      // bias, activation, one cast; d[4j + 2h + e] is row m0 + 8h,
      // channel 8j + c0 + e
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int y = sp.y0 + (q * ROWS + k) * g.dil;
        if (y >= g.H) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = sp.x0 + m0 + 8 * h;
          if (x >= g.W) continue;
          __nv_bfloat16* o =
              out + (((long long)sp.b * g.H + y) * g.W + x) * N + c0;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const float v0 = conv::activate(
                acc[k][4 * j + 2 * h] + bv[2 * j], g.act);
            const float v1 = conv::activate(
                acc[k][4 * j + 2 * h + 1] + bv[2 * j + 1], g.act);
            *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    rc += ROWS * sp.groups + 2;
  }
}

// ------------------------------------------------------------- host --- //

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The CP of a group of c channels: the narrowest swizzle row that holds
// it, 64 channels (128 bytes) at most.
inline int piece_channels(int c) { return c <= 16 ? 16 : c <= 32 ? 32 : 64; }

// The map of one NHWC bf16 input group of c channels, dims (c, x, y,
// batch), box (CP, box_x, 1, 1), swizzled by the CP * 2 bytes of a pixel.
inline int make_map(CUtensorMap* map, const void* x, int c, const Geom& g) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int cp = piece_channels(c);
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)g.W,
                              (cuuint64_t)g.H, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {c * e, (cuuint64_t)g.W * c * e,
                                 (cuuint64_t)g.H * g.W * c * e};
  const cuuint32_t box[4] = {(cuuint32_t)cp, (cuuint32_t)g.box_x, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = cp == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cp == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(x), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline uint32_t round_up(uint32_t v, uint32_t m) { return (v + m - 1) / m * m; }

// The geometry of a layer of groups of ca and cb channels (cb may be 0):
// the pieces, the ring as deep as fits (ROWS + 2 halo rows at least, so
// that a group can run; MAX_SLOTS at most); false if even the shallowest
// ring does not fit a block's shared memory or the pieces are too many.
inline bool plan(Geom* g, int ca, int cb, int cout) {
  g->nseg = TILE_X + 2 * g->dil <= MAX_BOX_X ? 1 : 3;
  g->box_x = g->nseg == 1 ? (int)round_up(TILE_X + 2 * g->dil, 8) : TILE_X;
  g->npieces = 0;
  uint32_t aoff = 0, woff = 0, tx = 0;
  const int cs[2] = {ca, cb};
  for (int m = 0; m < 2; ++m) {
    const int cp = piece_channels(cs[m]);
    for (int c0 = 0; c0 < cs[m]; c0 += cp) {
      if (g->npieces == MAX_PIECES) return false;
      Piece& pc = g->pc[g->npieces++];
      pc.map = m;
      pc.c0 = c0;
      pc.ksteps = cp / 16;
      pc.sp = 2u * cp;
      pc.aoff = aoff;
      pc.areg = round_up(g->box_x * pc.sp, ALIGN);
      pc.woff = woff;
      aoff += g->nseg * pc.areg;
      woff += round_up(cout * pc.sp, ALIGN);
      tx += g->nseg * g->box_x * pc.sp;
    }
  }
  g->row = aoff;
  g->tx_bytes = tx;
  g->wtap = woff;
  g->w_bytes = 9 * woff;
  const long long fixed = ALIGN + (long long)g->w_bytes;
  const long long per_slot = (long long)g->row + 16;
  const long long fit = (SMEM_LIMIT - fixed) / per_slot;
  if (fit < ROWS + 2) return false;
  g->slots = (int)(fit < MAX_SLOTS ? fit : MAX_SLOTS);
  g->smem = (int)(fixed + per_slot * g->slots);
  g->phases = g->dil < g->H ? g->dil : g->H;
  const int per_phase = (g->H + g->dil - 1) / g->dil;
  g->chunks = (per_phase + STRIP_ROWS - 1) / STRIP_ROWS;
  g->xtiles = (g->W + TILE_X - 1) / TILE_X;
  const long long n = (long long)g->B * g->phases * g->chunks * g->xtiles;
  g->nstrips = (int)n;
  return n < (1LL << 31);
}

// One bf16 layer: xa (B, H, W, ca) [+ xb (B, H, W, cb)] -> out (B, H, W,
// N); w the packed bf16 weights of pack_conv_weights_wgmma. Returns
// cudaErrorInvalidValue for a layer whose weights and shallowest ring do
// not fit shared memory.
template <int N>
int launch(const void* xa, int ca, const void* xb, int cb, const void* w,
           const float* bias, void* out, int B, int H, int W, int dil,
           int act, cudaStream_t stream) {
  Geom g = {};
  g.B = B;
  g.H = H;
  g.W = W;
  g.dil = dil;
  g.act = act;
  if (!plan(&g, ca, cb, N)) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int rc = make_map(&ma, xa, ca, g);
  if (rc != 0) return rc;
  mb = ma;
  if (cb) {
    rc = make_map(&mb, xb, cb, g);
    if (rc != 0) return rc;
  }
  // the nets' layers (one or two groups of 24 or 32 channels: one or two
  // 64-byte pieces) get the kernel that names its pieces at compile time
  const bool nets = g.npieces <= 2 && g.pc[0].sp == 64 &&
                    g.pc[g.npieces - 1].sp == 64;
  const void* kern =
      !nets             ? (const void*)conv3x3_wgmma_kernel<N, 0, 0>
      : g.npieces == 1  ? (const void*)conv3x3_wgmma_kernel<N, 64, 1>
                        : (const void*)conv3x3_wgmma_kernel<N, 64, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      g.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sms;
  if (grid > g.nstrips) grid = g.nstrips;
  void* args[] = {&ma, &mb, &w, &bias, &out, &g};
  err = cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(THREADS), args,
                         (size_t)g.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace wgmma_conv
}  // namespace llie
