// K6's bf16 form on the tensor cores: one 3x3 conv layer as an implicit
// GEMM of wgmma (sm_90a) fed by TMA. mxu_conv.cu launches it for bf16, and
// K7 (fcn_cascade.cu) runs its producer and consumers layer after layer;
// the f32 forms keep conv3x3.cuh on the CUDA cores.
//
// The GEMM. M = output pixels: one wgmma M tile is 64 consecutive x of
// one output row. N = Cout, padded to a multiple of 8 (zero weights and
// bias past the layer's channels, which the epilogue does not store) and
// cut into chunks of NC channels, NC the widest multiple of 8 up to 64
// that divides it (m64nNCk16; 64 keeps a row group's accumulators at 64
// registers a thread). K = 9 taps x Cin in k16 steps, walked tap-major,
// then piece by piece (below), 16 channels a step. The bf16 products sum
// in f32 registers; the epilogue adds the f32 bias, applies the activation
// in f32 and casts once to bf16 (the contract of kernels/mxu_conv.py).
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
// chunk by chunk, and within a chunk for each tap and piece an NC x CP
// K-major matrix in the piece's swizzle, each 1024-byte aligned. A block
// copies the chunks it runs into shared memory once: all of them where
// they fit beside the ring, else the grid is cut into `nsplit` slices of
// `npass` chunks each (blockIdx % nsplit), each block walking the strips
// for its slice, so that a layer of any width is still one launch (each
// slice reads the input again, from the L2).
//
// Piece groups. Where even one chunk's weights and a ring of whole halo
// rows do not fit (more than five 64-channel pieces at dilation 1:
// curve_features above 128), a slot holds the rows of `ppg` pieces only
// and a row group walks the `pgroups` groups of pieces in turn, its
// accumulators held in registers across them (one chunk a block). A row
// group then loads its ROWS + 2 rows once per piece group (no row is
// shared between row groups), and both consumers pass every row in order,
// the one that does not read it arriving at once, so that a slot is
// refilled only after both have passed it.
//
// Streamed weights. Where even one chunk's weights do not fit beside a
// ring of piece groups (more than 16 pieces of 64 channels, Cin > 1024,
// or 14 at dilation 64 and more), a block holds no chunk: with each row
// group and piece group the producer also copies that piece group's
// weights of the block's chunk (9 taps, cp.async.bulk) into one of two
// weight buffers, which the consumers pass in turn as they pass the
// ring's slots. Its pieces are worked out on the device from the two
// groups' widths (no table), so it takes any Cin, in one launch. Only
// this form (conv3x3_stream_kernel) reads weights per row group.
//
// The pipeline. One producer thread issues the TMA loads of the halo rows
// in order; two consumer warpgroups take the row groups in turn, so one's
// epilogue overlaps the other's wgmma. The first wgmma of a group writes
// the accumulators (scale-d 0), and the warp roles are read through a
// shuffle, so that ptxas sees no register defined outside wgmma and no
// divergent path between them: otherwise it serializes the wgmma (ptxas
// C7520). The nets' layers at 32 features (one or two 64-byte pieces, one
// chunk of N = Cout) run a kernel that names its pieces at compile time,
// every descriptor a base plus a constant, with the bias in registers and
// every store a pair; other widths walk their pieces and chunks at run
// time, more slowly (the chunk loop and the checked stores alone cost the
// nets' layers 10-40% on the H100 when they ran that way).
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
constexpr int MAX_PIECES = 16;       // the table: Cin <= 1024 (past it,
                                     // the streamed form works the pieces
                                     // out on the device)
constexpr int MAX_SLOTS = 16;        // halo rows in the ring
constexpr int MAX_N = 64;            // the widest chunk of output channels
constexpr uint32_t ALIGN = 1024;     // the 128-byte swizzle's period

// One piece of an input group: CP channels from channel c0 of group `map`.
struct Piece {
  int map, c0, ksteps;  // ksteps = CP / 16
  uint32_t sp;          // bytes a pixel: 2 * CP = the swizzle width
  uint32_t aoff;        // its region in a slot, from the first piece of
                        // its piece group (per dx box if nseg 3)
  uint32_t areg;        // bytes of one such region
  uint32_t woff;        // its weights within a tap of a chunk
};

// The layer's geometry, computed on the host (plan()), for layers of up to
// MP pieces (K6: MAX_PIECES; K7's layers have one).
template <int MP>
struct GeomT {
  static constexpr int PIECES = MP;
  int B, H, W, dil, act;
  int phases, chunks, xtiles;  // strips: B * phases * chunks * xtiles
  int nstrips;
  int slots;            // halo rows in the ring
  int nseg, box_x;      // boxes a halo row (1 or 3) and their pixels
  int npieces;
  int ppg, pgroups;     // pieces a slot holds, and the groups of them
  int cout;             // the layer's output channels (the output's stride)
  int nchunks;          // chunks of NC output channels (Cout padded)
  int npass;            // chunks a block holds and runs per row group
  int nsplit;           // slices of npass chunks: nchunks / npass
  Piece pc[MP];
  uint32_t row;         // bytes of a slot (the widest piece group)
  uint32_t tx_bytes;    // bytes TMA delivers into a whole halo row
  uint32_t wtap;        // bytes of one tap of one chunk's weights
  uint32_t wchunk;      // bytes of one chunk's weights (9 taps)
  uint32_t w_bytes;     // bytes of a block's weights (npass chunks)
  int smem;             // dynamic shared memory to ask for
  // the streamed form: the pieces of group a, the bytes a pixel of a
  // group a and a group b piece, the bytes a tap of the widest piece
  // group's weights, and 1 where the layer streams its weights
  int npa;
  uint32_t spa, spb, wpg;
  int stream;
};
using Geom = GeomT<MAX_PIECES>;

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
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, "
        "p, 1, 1, 0, 0;\n}\n"
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
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<40> {
  static __device__ void run(float (&d)[20], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<48> {
  static __device__ void run(float (&d)[24], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, "
        "p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<56> {
  static __device__ void run(float (&d)[28], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27}, %28, %29, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ void run(float (&d)[32], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
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
template <class G>
__device__ __forceinline__ Strip strip_at(const G& g, int t) {
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
__device__ __forceinline__ uint32_t readers(int j, int groups) {
  const int hi = min(groups - 1, j / ROWS);
  const int lo = j <= ROWS + 1 ? 0 : (j - 2) / ROWS;
  return (uint32_t)(hi - lo + 1);
}

// The wgmma of one row group and one chunk of N output channels (weights
// from `sw`): 9 taps x the pieces x their k16 steps x ROWS output rows,
// the first writing the accumulators (adding to them if `acc_in`). SP and
// NP > 0 name the pieces at compile time (NP pieces of SP bytes a pixel),
// so that every descriptor is a base plus a constant; 0 reads pieces p0 ..
// p1 - 1 from g.
template <int N, int SP, int NP, class G>
__device__ __forceinline__ void group_mma(float (&acc)[ROWS][N / 2],
                                          const G& g, uint32_t ring,
                                          const uint32_t (&slot)[ROWS + 2],
                                          uint32_t sw, int p0, int p1,
                                          int acc_in) {
  if constexpr (NP > 0) {
    constexpr uint32_t WP = (N * SP + ALIGN - 1) / ALIGN * ALIGN;
    constexpr int KS = SP / 32;
    const uint32_t dxb = g.nseg == 1 ? g.dil * SP : g.pc[0].areg;
    const uint32_t pstep = NP > 1 ? g.pc[NP - 1].aoff : 0;
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
      for (int p = p0; p < p1; ++p) {
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
                        db, (acc_in | tap | (p - p0) | kk) != 0);
        }
      }
    }
  }
}

// Shared memory of a block: [weights: w_bytes][ring: slots x row][full
// barriers][empty barriers][bias: npass * N floats], from the first ALIGN
// boundary of the dynamic shared memory (`base`).
struct Smem {
  uint32_t sw, ring, full0, empty0, bias;
};

template <class G>
__device__ __forceinline__ Smem smem_layout(const G& g, uint32_t base) {
  Smem s;
  s.sw = base;
  s.ring = s.sw + g.w_bytes;
  s.full0 = s.ring + g.slots * g.row;
  s.empty0 = s.full0 + 8 * g.slots;
  s.bias = s.empty0 + 8 * g.slots;
  return s;
}

// The producer: one thread issues the TMA loads of the halo rows of strips
// t0, t0 + ts, ... in order; `rc` counts the rows issued (carried from
// layer to layer by K7). GROUPS (the run-time-piece kernel of K6): a row
// group with piece groups loads its ROWS + 2 rows once for each piece
// group, the pieces of one group into a slot.
template <bool GROUPS, class G>
__device__ __forceinline__ void produce(const G& g,
                                        const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        const Smem& sm, int t0, int ts,
                                        uint32_t& rc) {
  // input row y, pieces p0 .. p1 - 1 (tx bytes of them), into the next slot
  auto load = [&](const Strip& sp, int y, int p0, int p1, uint32_t tx) {
    const uint32_t s = rc % g.slots;
    mbar_wait(sm.empty0 + 8 * s, ((rc / g.slots) & 1) ^ 1);
    const uint32_t bar = sm.full0 + 8 * s;
    mbar_expect_tx(bar, tx);
#pragma unroll 1
    for (int p = p0; p < (G::PIECES == 1 ? 1 : p1); ++p) {
      const Piece& pc = g.pc[G::PIECES == 1 ? 0 : p];
      const CUtensorMap* map = pc.map ? map_b : map_a;
#pragma unroll 1
      for (int k = 0; k < g.nseg; ++k) {
        const int x = g.nseg == 1 ? sp.x0 - g.dil : sp.x0 + (k - 1) * g.dil;
        tma_load4(sm.ring + s * g.row + pc.aoff + k * pc.areg, map, bar,
                  pc.c0, x, y, sp.b);
      }
    }
    ++rc;
  };
  for (int t = t0; t < g.nstrips; t += ts) {
    const Strip sp = strip_at(g, t);
    if (!sp.live) continue;
    if (GROUPS && g.pgroups > 1) {
#pragma unroll 1
      for (int q = 0; q < sp.groups; ++q)
#pragma unroll 1
        for (int p0 = 0; p0 < g.npieces; p0 += g.ppg) {
          const int p1 = min(p0 + g.ppg, g.npieces);
          uint32_t tx = 0;
          for (int p = p0; p < p1; ++p) tx += g.nseg * g.box_x * g.pc[p].sp;
#pragma unroll 1
          for (int j = 0; j < ROWS + 2; ++j)
            load(sp, sp.y0 + (q * ROWS + j - 1) * g.dil, p0, p1, tx);
        }
      continue;
    }
#pragma unroll 1
    for (int j = 0; j < ROWS * sp.groups + 2; ++j)
      load(sp, sp.y0 + (j - 1) * g.dil, 0, g.npieces, g.tx_bytes);
  }
}

// The epilogue of row group q of strip sp and chunk ch0 (output channels
// cb = c_base + ch0 * N + c0 ...): bias `bv`, activation, one cast;
// d[4j + 2h + e] is row m0 + 8h, channel 8j + c0 + e of the chunk, and
// channels past cout are padding. ONE: N == cout, every store a pair.
template <int N, bool ONE, class G>
__device__ __forceinline__ void store_group(const float (&acc)[ROWS][N / 2],
                                            const float (&bv)[N / 4],
                                            const G& g, const Strip& sp,
                                            int q, int m0, int cb, int cout,
                                            __nv_bfloat16* __restrict__ out) {
  const bool pairs = (cout & 1) == 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = sp.y0 + (q * ROWS + k) * g.dil;
    if (y >= g.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = sp.x0 + m0 + 8 * h;
      if (x >= g.W) continue;
      __nv_bfloat16* o =
          out + (((long long)sp.b * g.H + y) * g.W + x) * cout + cb;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float v0 =
            conv::activate(acc[k][4 * j + 2 * h] + bv[2 * j], g.act);
        const float v1 =
            conv::activate(acc[k][4 * j + 2 * h + 1] + bv[2 * j + 1], g.act);
        const int ch = cb + 8 * j;
        if (ONE || (ch + 1 < cout && pairs)) {
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (ch < cout) o[8 * j] = __float2bfloat16_rn(v0);
          if (ch + 1 < cout) o[8 * j + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// A consumer warpgroup (wg of CONSUMERS): of the row groups of strips t0,
// t0 + ts, ... those of its turn (qc counts the block's row groups); for
// each, the g.npass chunks held at sm.sw, written to output channels
// c_base, c_base + N, ... of `out` (image b of a strip at out + b * H * W
// * cout). `rc` follows the producer's row count. The kernels with
// compile-time pieces (NP > 0) run one chunk of N == cout channels: the
// bias stays in registers and every store is a pair.
template <int N, int SP, int NP, class G>
__device__ __forceinline__ void consume(const G& g, const Smem& sm,
                                        __nv_bfloat16* __restrict__ out,
                                        int c_base, int wg, int t0, int ts,
                                        uint32_t& rc, int& qc) {
  const int wtid = threadIdx.x % 128;
  const int m0 = (wtid / 32) * 16 + (wtid % 32) / 4;  // rows m0, m0 + 8
  const int c0 = 2 * (wtid % 4);  // channels c0, c0 + 1 of each 8
  constexpr bool ONE = NP > 0;
  // piece groups: only the run-time-piece kernel of K6 is planned with them
  constexpr bool GROUPS = NP == 0 && G::PIECES > 1;
  const int npass = ONE ? 1 : g.npass;
  const int cout = ONE ? N : g.cout;
  const float* sbias =
      reinterpret_cast<const float*>(__cvta_shared_to_generic(sm.bias));
  float bv[N / 4];
  auto load_bias = [&](int ch0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      bv[2 * j] = sbias[ch0 * N + 8 * j + c0];
      bv[2 * j + 1] = sbias[ch0 * N + 8 * j + c0 + 1];
    }
  };
  load_bias(0);
  for (int t = t0; t < g.nstrips; t += ts) {
    const Strip sp = strip_at(g, t);
    if (!sp.live) continue;
    if (GROUPS && g.pgroups > 1) {
      const uint32_t unit = ROWS + 2;  // rows of a row group and piece group
#pragma unroll 1
      for (int q = 0; q < sp.groups; ++q, ++qc) {
        if (qc % CONSUMERS != wg) {
          // the other consumer's rows: pass each once it has landed
#pragma unroll 1
          for (uint32_t j = 0; j < g.pgroups * unit; ++j, ++rc) {
            const uint32_t s = rc % g.slots;
            mbar_wait(sm.full0 + 8 * s, (rc / g.slots) & 1);
            if (wtid == 0) mbar_arrive(sm.empty0 + 8 * s, 1);
          }
          continue;
        }
        float acc[ROWS][N / 2];
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
#pragma unroll 1
        for (int pg = 0; pg < g.pgroups; ++pg, rc += unit) {
          uint32_t slot[ROWS + 2];
#pragma unroll
          for (int j = 0; j < ROWS + 2; ++j) {
            const uint32_t r = rc + j;
            slot[j] = r % g.slots;
            mbar_wait(sm.full0 + 8 * slot[j], (r / g.slots) & 1);
          }
          const int p0 = pg * g.ppg;
          wgmma_fence();
          group_mma<N, SP, NP>(acc, g, sm.ring, slot, sm.sw, p0,
                               min(p0 + g.ppg, g.npieces), pg);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
          if (wtid == 0) {
#pragma unroll
            for (int j = 0; j < ROWS + 2; ++j)
              mbar_arrive(sm.empty0 + 8 * slot[j], 1);
          }
        }
        store_group<N, false>(acc, bv, g, sp, q, m0, c_base + c0, cout, out);
      }
      continue;
    }
#pragma unroll 1
    for (int q = 0; q < sp.groups; ++q, ++qc) {
      if (qc % CONSUMERS != wg) continue;
      uint32_t slot[ROWS + 2];
#pragma unroll
      for (int j = 0; j < ROWS + 2; ++j) {
        const uint32_t r = rc + q * ROWS + j;
        slot[j] = r % g.slots;
        mbar_wait(sm.full0 + 8 * slot[j], (r / g.slots) & 1);
      }
#pragma unroll 1
      for (int ch0 = 0; ch0 < npass; ++ch0) {
        float acc[ROWS][N / 2];
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
        wgmma_fence();
        group_mma<N, SP, NP>(acc, g, sm.ring, slot, sm.sw + ch0 * g.wchunk,
                             0, g.npieces, 0);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
        // after the last chunk the group's rows are read: one arrival for
        // each, two where it is the row's only reader
        if (ch0 == npass - 1 && wtid == 0) {
#pragma unroll
          for (int j = 0; j < ROWS + 2; ++j)
            mbar_arrive(sm.empty0 + 8 * slot[j],
                        3 - readers(q * ROWS + j, sp.groups));
        }
        if (npass > 1) load_bias(ch0);
        store_group<N, ONE>(acc, bv, g, sp, q, m0, c_base + ch0 * N + c0,
                            cout, out);
      }
    }
    rc += ROWS * sp.groups + 2;
  }
}

// Copies `bytes` (a multiple of 16) from global w to shared `dst`, with
// every thread of the block.
__device__ __forceinline__ void copy16(uint32_t dst, const void* w,
                                       uint32_t bytes) {
  const uint4* src = reinterpret_cast<const uint4*>(w);
  uint4* d = reinterpret_cast<uint4*>(__cvta_shared_to_generic(dst));
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    d[i] = src[i];
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
  const uint32_t raw = smem_u32(smem_raw);
  const Smem sm =
      smem_layout(g, raw + ((ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1)));
  // this block's slice of the output channels: chunks split * npass ...
  const int split = blockIdx.x % g.nsplit;
  copy16(sm.sw, reinterpret_cast<const unsigned char*>(w) +
                    (size_t)split * g.w_bytes, g.w_bytes);
  {
    float* sb = reinterpret_cast<float*>(__cvta_shared_to_generic(sm.bias));
    for (int i = threadIdx.x; i < g.npass * N; i += THREADS)
      sb[i] = bias[split * g.npass * N + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(sm.full0 + 8 * s, 1);
      mbar_init(sm.empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the weights' generic-proxy writes, visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int t0 = blockIdx.x / g.nsplit, ts = gridDim.x / g.nsplit;
  uint32_t rc = 0;
  if (wg == CONSUMERS) {
    if (threadIdx.x % 128 == 0)
      produce<NP == 0>(g, &map_a, &map_b, sm, t0, ts, rc);
    return;
  }
  int qc = 0;
  consume<N, SP, NP>(g, sm, out, split * g.npass * N, wg, t0, ts, rc, qc);
}

// ------------------------------------------------- streamed weights --- //

// Copies `bytes` (a multiple of 16) from global `src` to shared `dst`,
// completing on mbarrier `bar` (the async proxy, as TMA).
inline __device__ void bulk_copy(uint32_t dst, const void* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Piece p of a layer of the streamed form, at chunk width N, within the
// piece group that starts at piece p0: pieces 0 .. npa - 1 are group a's
// (2 * spa... CP = spa / 2 channels each), the rest group b's. aoff and
// woff are from piece p0 (its slot region, its weights in a tap).
template <int N, class G>
__device__ __forceinline__ Piece piece_at(const G& g, int p, int p0) {
  const bool a = p < g.npa;
  const uint32_t sp = a ? g.spa : g.spb;
  const uint32_t areg_a = (g.box_x * g.spa + ALIGN - 1) / ALIGN * ALIGN;
  const uint32_t areg_b = (g.box_x * g.spb + ALIGN - 1) / ALIGN * ALIGN;
  const uint32_t wp_a = (N * g.spa + ALIGN - 1) / ALIGN * ALIGN;
  const uint32_t wp_b = (N * g.spb + ALIGN - 1) / ALIGN * ALIGN;
  const int na = max(0, min(p, g.npa) - p0);
  const int nb = p - p0 - na;
  Piece pc;
  pc.map = a ? 0 : 1;
  pc.c0 = (a ? p : p - g.npa) * (int)(sp / 2);
  pc.ksteps = (int)(sp / 32);
  pc.sp = sp;
  pc.areg = a ? areg_a : areg_b;
  pc.aoff = g.nseg * (na * areg_a + nb * areg_b);
  pc.woff = na * wp_a + nb * wp_b;
  return pc;
}

// The streamed form's shared memory past the bias: two weight buffers'
// full and empty barriers.
__device__ __forceinline__ uint32_t stream_bars(const Smem& sm, int n) {
  return (sm.bias + 4 * n + 7) & ~7u;
}

// The producer of the streamed form: for each row group and piece group,
// the piece group's weights of the block's chunk (`wsrc`, 9 taps) into
// weight buffer wc % 2, then the ROWS + 2 halo rows of its pieces into
// the ring.
template <int N, class G>
__device__ __forceinline__ void produce_stream(
    const G& g, const CUtensorMap* map_a, const CUtensorMap* map_b,
    const Smem& sm, const unsigned char* wsrc, int t0, int ts) {
  const uint32_t wbar = stream_bars(sm, N);
  uint32_t rc = 0, wc = 0;
  for (int t = t0; t < g.nstrips; t += ts) {
    const Strip sp = strip_at(g, t);
    if (!sp.live) continue;
#pragma unroll 1
    for (int q = 0; q < sp.groups; ++q)
#pragma unroll 1
      for (int p0 = 0; p0 < g.npieces; p0 += g.ppg) {
        const int p1 = min(p0 + g.ppg, g.npieces);
        // the weights: a tap's pieces p0 .. p1 - 1 lie together
        const Piece first = piece_at<N>(g, p0, 0);
        const uint32_t wb = piece_at<N>(g, p1, p0).woff;
        const uint32_t s = wc % 2;
        mbar_wait(wbar + 16 + 8 * s, ((wc / 2) & 1) ^ 1);
        mbar_expect_tx(wbar + 8 * s, 9 * wb);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap)
          bulk_copy(sm.sw + s * 9 * g.wpg + tap * g.wpg,
                    wsrc + (size_t)tap * g.wtap + first.woff, wb,
                    wbar + 8 * s);
        ++wc;
        uint32_t tx = 0;
        for (int p = p0; p < p1; ++p)
          tx += g.nseg * g.box_x * piece_at<N>(g, p, p0).sp;
#pragma unroll 1
        for (int j = 0; j < ROWS + 2; ++j) {
          const int y = sp.y0 + (q * ROWS + j - 1) * g.dil;
          const uint32_t slot = rc % g.slots;
          mbar_wait(sm.empty0 + 8 * slot, ((rc / g.slots) & 1) ^ 1);
          const uint32_t bar = sm.full0 + 8 * slot;
          mbar_expect_tx(bar, tx);
#pragma unroll 1
          for (int p = p0; p < p1; ++p) {
            const Piece pc = piece_at<N>(g, p, p0);
            const CUtensorMap* map = pc.map ? map_b : map_a;
#pragma unroll 1
            for (int k = 0; k < g.nseg; ++k) {
              const int x = g.nseg == 1 ? sp.x0 - g.dil
                                        : sp.x0 + (k - 1) * g.dil;
              tma_load4(sm.ring + slot * g.row + pc.aoff + k * pc.areg, map,
                        bar, pc.c0, x, y, sp.b);
            }
          }
          ++rc;
        }
      }
  }
}

// The wgmma of one row group over the pieces p0 .. p1 - 1 of the streamed
// form, their weights in buffer `wbuf` (a tap every g.wpg bytes).
template <int N, class G>
__device__ __forceinline__ void group_mma_stream(
    float (&acc)[ROWS][N / 2], const G& g, uint32_t ring,
    const uint32_t (&slot)[ROWS + 2], uint32_t wbuf, int p0, int p1,
    int acc_in) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
    for (int p = p0; p < p1; ++p) {
      const Piece pc = piece_at<N>(g, p, p0);
      const uint32_t a_dx =
          pc.aoff + (g.nseg == 1 ? dx * g.dil * pc.sp : dx * pc.areg);
      const uint32_t b0 = wbuf + tap * g.wpg + pc.woff;
#pragma unroll 1
      for (int kk = 0; kk < pc.ksteps; ++kk) {
        const uint64_t db = mat_desc(b0 + 32 * kk, pc.sp);
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          Mma<N>::run(acc[k],
                      mat_desc(ring + slot[k + dy] * g.row + a_dx + 32 * kk,
                               pc.sp),
                      db, (acc_in | tap | (p - p0) | kk) != 0);
      }
    }
  }
}

// A consumer warpgroup of the streamed form: as consume()'s piece-group
// path, each piece group's weights waited for in their buffer and
// released with its rows; one chunk a block, channels c_base ...
template <int N, class G>
__device__ __forceinline__ void consume_stream(const G& g, const Smem& sm,
                                               __nv_bfloat16* __restrict__ out,
                                               int c_base, int wg, int t0,
                                               int ts) {
  const int wtid = threadIdx.x % 128;
  const int m0 = (wtid / 32) * 16 + (wtid % 32) / 4;
  const int c0 = 2 * (wtid % 4);
  const uint32_t wbar = stream_bars(sm, N);
  const float* sbias =
      reinterpret_cast<const float*>(__cvta_shared_to_generic(sm.bias));
  float bv[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bv[2 * j] = sbias[8 * j + c0];
    bv[2 * j + 1] = sbias[8 * j + c0 + 1];
  }
  uint32_t rc = 0, wc = 0;
  int qc = 0;
  for (int t = t0; t < g.nstrips; t += ts) {
    const Strip sp = strip_at(g, t);
    if (!sp.live) continue;
#pragma unroll 1
    for (int q = 0; q < sp.groups; ++q, ++qc) {
      if (qc % CONSUMERS != wg) {
        // the other consumer's weights and rows: pass each once landed
#pragma unroll 1
        for (int pg = 0; pg < g.pgroups; ++pg, ++wc) {
          const uint32_t s = wc % 2;
          mbar_wait(wbar + 8 * s, (wc / 2) & 1);
          if (wtid == 0) mbar_arrive(wbar + 16 + 8 * s, 1);
#pragma unroll 1
          for (int j = 0; j < ROWS + 2; ++j, ++rc) {
            const uint32_t slot = rc % g.slots;
            mbar_wait(sm.full0 + 8 * slot, (rc / g.slots) & 1);
            if (wtid == 0) mbar_arrive(sm.empty0 + 8 * slot, 1);
          }
        }
        continue;
      }
      float acc[ROWS][N / 2];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
#pragma unroll 1
      for (int pg = 0; pg < g.pgroups; ++pg, ++wc, rc += ROWS + 2) {
        const uint32_t s = wc % 2;
        mbar_wait(wbar + 8 * s, (wc / 2) & 1);
        uint32_t slot[ROWS + 2];
#pragma unroll
        for (int j = 0; j < ROWS + 2; ++j) {
          const uint32_t r = rc + j;
          slot[j] = r % g.slots;
          mbar_wait(sm.full0 + 8 * slot[j], (r / g.slots) & 1);
        }
        const int p0 = pg * g.ppg;
        wgmma_fence();
        group_mma_stream<N>(acc, g, sm.ring, slot, sm.sw + s * 9 * g.wpg, p0,
                            min(p0 + g.ppg, g.npieces), pg);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) fence_reg(acc[k][i]);
        if (wtid == 0) {
#pragma unroll
          for (int j = 0; j < ROWS + 2; ++j)
            mbar_arrive(sm.empty0 + 8 * slot[j], 1);
          mbar_arrive(wbar + 16 + 8 * s, 1);
        }
      }
      store_group<N, false>(acc, bv, g, sp, q, m0, c_base + c0, g.cout, out);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_stream_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      const __grid_constant__ Geom g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const Smem sm =
      smem_layout(g, raw + ((ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1)));
  const uint32_t wbar = stream_bars(sm, N);
  // this block's chunk of the output channels
  const int split = blockIdx.x % g.nsplit;
  {
    float* sb = reinterpret_cast<float*>(__cvta_shared_to_generic(sm.bias));
    for (int i = threadIdx.x; i < N; i += THREADS) sb[i] = bias[split * N + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(sm.full0 + 8 * s, 1);
      mbar_init(sm.empty0 + 8 * s, 2);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(wbar + 8 * s, 1);
      mbar_init(wbar + 16 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  const int t0 = blockIdx.x / g.nsplit, ts = gridDim.x / g.nsplit;
  if (wg == CONSUMERS) {
    if (threadIdx.x % 128 == 0)
      produce_stream<N>(g, &map_a, &map_b, sm,
                        reinterpret_cast<const unsigned char*>(w) +
                            (size_t)split * g.wchunk,
                        t0, ts);
    return;
  }
  consume_stream<N>(g, sm, out, split * N, wg, t0, ts);
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

// The map of one NHWC bf16 input group of c channels over `images` images
// of H x W, dims (c, x, y, image), box (CP, box_x, 1, 1), swizzled by the
// CP * 2 bytes of a pixel.
inline int make_map(CUtensorMap* map, const void* x, int c, int W, int H,
                    int images, int box_x) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int cp = piece_channels(c);
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)images};
  const cuuint64_t strides[3] = {c * e, (cuuint64_t)W * c * e,
                                 (cuuint64_t)H * W * c * e};
  const cuuint32_t box[4] = {(cuuint32_t)cp, (cuuint32_t)box_x, 1, 1};
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

// The pieces, slot and weight sizes of a layer of groups of ca and cb
// channels (cb may be 0) at chunk width n, `ppg` pieces a slot (at most),
// and its strips; the ring and the slices are left to plan(). False if the
// pieces are too many.
template <class G>
inline bool plan_layer(G* g, int ca, int cb, int cout, int n,
                       int ppg = MAX_PIECES, bool table = true) {
  g->nseg = TILE_X + 2 * g->dil <= MAX_BOX_X ? 1 : 3;
  g->box_x = g->nseg == 1 ? (int)round_up(TILE_X + 2 * g->dil, 8) : TILE_X;
  g->npieces = 0;
  uint32_t aoff = 0, woff = 0, tx = 0, row = 0, gw = 0, wpg = 0;
  const int cs[2] = {ca, cb};
  const int mp = (int)(sizeof(g->pc) / sizeof(g->pc[0]));
  for (int m = 0; m < 2; ++m) {
    const int cp = piece_channels(cs[m]);
    for (int c0 = 0; c0 < cs[m]; c0 += cp) {
      if (table && g->npieces == mp) return false;
      if (g->npieces % ppg == 0) aoff = gw = 0;  // a piece group: a slot
      Piece pc;
      pc.map = m;
      pc.c0 = c0;
      pc.ksteps = cp / 16;
      pc.sp = 2u * cp;
      pc.aoff = aoff;
      pc.areg = round_up(g->box_x * pc.sp, ALIGN);
      pc.woff = woff;
      if (g->npieces < mp) g->pc[g->npieces] = pc;
      ++g->npieces;
      aoff += g->nseg * pc.areg;
      woff += round_up(n * pc.sp, ALIGN);
      gw += round_up(n * pc.sp, ALIGN);
      tx += g->nseg * g->box_x * pc.sp;
      row = row > aoff ? row : aoff;
      wpg = wpg > gw ? wpg : gw;
    }
  }
  g->npa = (ca + piece_channels(ca) - 1) / piece_channels(ca);
  g->spa = 2u * piece_channels(ca);
  g->spb = cb ? 2u * piece_channels(cb) : g->spa;
  g->wpg = wpg;
  g->stream = 0;
  g->ppg = ppg < g->npieces ? ppg : g->npieces;
  g->pgroups = (g->npieces + g->ppg - 1) / g->ppg;
  g->row = row;
  g->tx_bytes = tx;
  g->wtap = woff;
  g->wchunk = 9 * woff;
  g->cout = cout;
  g->nchunks = (int)round_up(cout, 8) / n;
  g->phases = g->dil < g->H ? g->dil : g->H;
  const int per_phase = (g->H + g->dil - 1) / g->dil;
  g->chunks = (per_phase + STRIP_ROWS - 1) / STRIP_ROWS;
  g->xtiles = (g->W + TILE_X - 1) / TILE_X;
  const long long strips = (long long)g->B * g->phases * g->chunks *
                           g->xtiles;
  g->nstrips = (int)strips;
  return strips < (1LL << 31);
}

// plan() tries these stages in turn: whole halo rows a slot, a ring of
// 2 * ROWS + 4 slots (both consumers busy and the next rows loading), then
// of ROWS + 2 (a group can run); then the same with piece groups; then
// streamed weights (the fewest piece groups whose two weight buffers and
// a ring of at least ROWS + 2 slots fit).
constexpr int PLAN_STAGES = 5;
constexpr int STREAM_STAGE = 4;

// The streamed form's plan at chunk width n: one chunk a block, two
// weight buffers of a piece group's 9 taps, their four barriers (and 8
// bytes of alignment) past the bias.
template <class G>
inline bool plan_stream(G* g, int ca, int cb, int cout, int n) {
  if (!plan_layer(g, ca, cb, cout, n, MAX_PIECES, false)) return false;
  const int pieces = g->npieces;
  for (int pgroups = 1; pgroups <= pieces; ++pgroups) {
    const int ppg = (pieces + pgroups - 1) / pgroups;
    if ((pieces + ppg - 1) / ppg != pgroups) continue;  // a split seen
    plan_layer(g, ca, cb, cout, n, ppg, false);
    const long long per_slot = (long long)g->row + 16;
    const long long fixed =
        ALIGN + 2LL * 9 * g->wpg + 4LL * n + 8 + 32;
    const long long fit = (SMEM_LIMIT - fixed) / per_slot;
    if (fit < ROWS + 2) continue;
    g->npass = 1;
    g->nsplit = g->nchunks;
    g->w_bytes = 2 * 9 * g->wpg;
    g->slots = (int)(fit < MAX_SLOTS ? fit : MAX_SLOTS);
    g->smem = (int)(fixed + per_slot * g->slots);
    g->stream = 1;
    return true;
  }
  return false;
}

// The ring, the slices and the piece groups of a layer at chunk width n
// at plan stage `stage`: whole halo rows and the most chunks a block can
// hold (a divisor of nchunks), or the fewest piece groups (as even as they
// go) with one chunk a block; the ring then as deep as fits, MAX_SLOTS at
// most. False if nothing fits.
template <class G>
inline bool plan_stage(G* g, int ca, int cb, int cout, int n, int stage) {
  if (stage == STREAM_STAGE) return plan_stream(g, ca, cb, cout, n);
  const int want = stage % 2 ? ROWS + 2 : 2 * ROWS + 4;
  const bool groups = stage >= 2;
  if (!plan_layer(g, ca, cb, cout, n)) return false;
  const int pieces = g->npieces;
  for (int pgroups = groups ? 2 : 1; pgroups <= (groups ? pieces : 1);
       ++pgroups) {
    const int ppg = (pieces + pgroups - 1) / pgroups;
    if ((pieces + ppg - 1) / ppg != pgroups) continue;  // a split seen
    if (groups) plan_layer(g, ca, cb, cout, n, ppg);
    const long long per_slot = (long long)g->row + 16;
    for (int np = groups ? 1 : g->nchunks; np >= 1; --np) {
      if (g->nchunks % np) continue;
      const long long fixed =
          ALIGN + (long long)np * g->wchunk + 4LL * np * n;
      const long long fit = (SMEM_LIMIT - fixed) / per_slot;
      if (fit < want) continue;
      g->npass = np;
      g->nsplit = g->nchunks / np;
      g->w_bytes = np * g->wchunk;
      g->slots = (int)(fit < MAX_SLOTS ? fit : MAX_SLOTS);
      g->smem = (int)(fixed + per_slot * g->slots);
      return true;
    }
  }
  return false;
}

// The plan of a layer at chunk width n: its first stage that fits.
template <class G>
inline bool plan(G* g, int ca, int cb, int cout, int n) {
  for (int stage = 0; stage < PLAN_STAGES; ++stage)
    if (plan_stage(g, ca, cb, cout, n, stage)) return true;
  return false;
}

// The chunk width a bf16 layer of input groups of ca and cb channels
// (multiples of 8; cb may be 0) -> cout at dilation dil runs at: at the
// first plan stage where any fits, the widest multiple of 8 up to MAX_N
// that divides cout rounded up to 8 (so that plan() at that width picks
// that stage); 0 where none fits.
inline int chunk_width(int ca, int cb, int cout, int dil) {
  const int c8 = (cout + 7) / 8;
  for (int stage = 0; stage < PLAN_STAGES; ++stage)
    for (int d = MAX_N / 8; d >= 1; --d) {
      if (c8 % d) continue;
      Geom g = {};
      g.B = g.H = g.W = 1;
      g.dil = dil;
      if (plan_stage(&g, ca, cb, cout, 8 * d, stage)) return 8 * d;
    }
  return 0;
}

// SMs and the blocks of `kern` that fit on one at `smem` bytes.
inline int card_fit(const void* kern, int smem, int* sms, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// One bf16 layer at chunk width N: xa (B, H, W, ca) [+ xb (B, H, W, cb)]
// -> out (B, H, W, cout); w the packed bf16 weights of
// pack_conv_weights_wgmma, bias f32 padded to the chunks. Returns
// cudaErrorInvalidValue for a layer that plan() cannot fit in shared
// memory at N.
template <int N>
int launch(const void* xa, int ca, const void* xb, int cb, const void* w,
           const float* bias, void* out, int cout, int B, int H, int W,
           int dil, int act, cudaStream_t stream) {
  Geom g = {};
  g.B = B;
  g.H = H;
  g.W = W;
  g.dil = dil;
  g.act = act;
  if (!plan(&g, ca, cb, cout, N)) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int rc = make_map(&ma, xa, ca, W, H, B, g.box_x);
  if (rc != 0) return rc;
  mb = ma;
  if (cb) {
    rc = make_map(&mb, xb, cb, W, H, B, g.box_x);
    if (rc != 0) return rc;
  }
  // the nets' layers at 32 features (one or two groups of 24 or 32
  // channels: one or two 64-byte pieces, one chunk of N == cout up to 32)
  // get the kernel that names its pieces at compile time
  const bool nets = g.npieces <= 2 && g.pc[0].sp == 64 &&
                    g.pc[g.npieces - 1].sp == 64 && g.npass == 1 &&
                    g.nsplit == 1 && g.pgroups == 1 && cout == N;
  const void* kern = g.stream ? (const void*)conv3x3_stream_kernel<N>
                              : (const void*)conv3x3_wgmma_kernel<N, 0, 0>;
  if constexpr (N <= 32) {
    if (nets && !g.stream)
      kern = g.npieces == 1 ? (const void*)conv3x3_wgmma_kernel<N, 64, 1>
                            : (const void*)conv3x3_wgmma_kernel<N, 64, 2>;
  }
  int sms = 0, per_sm = 0;
  rc = card_fit(kern, g.smem, &sms, &per_sm);
  if (rc != 0) return rc;
  // every slice gets the same number of blocks; at least one each
  long long grid = (long long)per_sm * sms / g.nsplit;
  if (grid > g.nstrips) grid = g.nstrips;
  if (grid < 1) grid = 1;
  grid *= g.nsplit;
  void* args[] = {&ma, &mb, &w, &bias, &out, &g};
  const cudaError_t err =
      cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(THREADS), args,
                       (size_t)g.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace wgmma_conv
}  // namespace llie
