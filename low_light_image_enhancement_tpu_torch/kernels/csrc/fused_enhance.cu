// The blur of radii past the tiles for Hopper (sm_90a), bound to PyTorch
// through ctypes (kernels/fused_enhance.py): blur_illumination, the
// illumination plane that the LPLANE forms of K1, K3 and K4
// (retinex_tile.cu, curve_tile.cu) and the guided tails (fused_guided.cu)
// read in place of their own blur.
//
// What it replaces. The separable blur that the TPU kernels run inside
// fused_retinex, fused_curve_enhance and fused_retinex_ema
// (low_light_image_enhancement_tpu/kernels/fused_enhance.py,
// separable_blur) at any radius; the kernels here run it at radii past
// MAX_BLUR_RADIUS, where the taps no longer fit the tiles' registers and
// halos.
//
// What bounds it. It reads the image (3 bytes a pixel on u8) and writes the
// f32 plane (4): device memory, on paper. Its 2 (2R + 1) multiplies and
// adds a position, each its own instruction under --fmad=false, come
// close: at r 16 they take some 2.3 times the bytes' time at the f32
// issue rate.
//
// What the design does about it. One launch, a 32 x 128 tile of the plane
// a block of 256 threads (the vertical pass computes 1.25 columns an
// output at r 16, against 1.5 on a 64-wide tile), nothing between the
// passes but shared memory:
//   1. staging: max RGB of the tile's rows and image columns plus R on each
//      side, clamped into the image, once a pixel: 4-pixel groups read as
//      aligned words (u8: the bytes' max taken four at a time, __vmaxu4,
//      before the one conversion) or float4 where inside the image, each
//      pixel at its clamped column elsewhere, a batch of groups' loads in
//      flight a thread;
//   2. the vertical pass in column strips of VS rows: the 2R + 1 taps run
//      as blocks of KB, then one block each of 8, 4, 2 and 1 for the rest
//      (33 taps: 16 + 16 + 1), so no block computes a term it drops; a
//      block of K taps holds a window of VS + K - 1 staged values in
//      registers and adds K terms to each of the strip's sums, so shared
//      memory is read about 0.3 times a multiply-add; the sums go to sV;
//   3. the horizontal pass on row segments of HS columns (a lane a row, odd
//      pitch), the same blocks along the row, its sums written to shared
//      memory and the tile stored from there as whole rows, a warp a row
//      (float4, or float2 where the plane's rows are 8-byte aligned): a
//      lane's own segment stored from registers would put 32 rows in each
//      store instruction.
// The radius is a run-time value (any radius the config takes): the taps
// are read a block at a time, 16-byte aligned and zero-padded, through the
// read-only cache. The planes' pitches are constants (every window offset
// an immediate), so a chunk computes at most CHUNK_COLS columns of sV, and
// the staged rows stop at CAP_BYTES (two blocks an SM): past R 32 the plan
// cuts the columns of sV and the staged rows into chunks, walked bottom-up
// and right-to-left so that every sum still takes its terms in order; each
// tap block runs in the chunk that holds its window's last row (column).
// Nothing divides an output: the tile's indices are 32-bit, only the
// global addresses 64-bit.
//
// Numerics: as fused_enhance.cuh (--fmad=false), and the tiles' order,
// separable_blur's: each sum starts from -0 (an exact identity for the
// first term) and adds taps[k] * v[y + R - k] for k ascending, vertical
// then horizontal, so that the LPLANE forms' results equal their tile-blur
// forms' and the plane equals its plain version bit for bit.
#include "retinex_tile.cuh"

namespace llie {
namespace blur {

constexpr int TH = 32;               // plane rows a tile
constexpr int TW = 128;              // plane columns a tile
constexpr int NT = 256;              // threads a block
constexpr int VS = 4;                // vertical pass: rows a strip
constexpr int HS = 16;               // horizontal pass: columns a segment
constexpr int KB = 16;               // taps a block
constexpr int NSTRIP = TH / VS;
// A vertical (horizontal) block's window reaches this many rows (columns)
// above (left of) the last one it reads.
constexpr int OVR = VS + KB - 2;
constexpr int OVC = HS + KB - 2;
// Shared memory a block may take (two blocks an SM), and the most columns
// of sV a chunk computes: the pitches are constants, so every window
// offset is an immediate (sM's a multiple of 4 for the staging's float4
// stores, sV's odd since the horizontal pass's lanes are rows).
constexpr int CAP_BYTES = 112 * 1024;
constexpr int CHUNK_COLS = 192;
constexpr int PM = CHUNK_COLS;
constexpr int PV = CHUNK_COLS + 1;
// The pitch of the output tile in shared memory (and of the horizontal
// sums kept between column chunks): 16-byte rows, and 8 lanes' float4 on
// 32 banks whether the lanes are rows or columns.
constexpr int OP = TW + 4;
static_assert(TH == 32 && TW == HS * (NT / 32),
              "horizontal pass: a lane a row, a warp a segment");
static_assert(TH % VS == 0 && KB % 4 == 0, "strips and float4 taps");

// The tile's plan at radius R. Staged row s <-> image row Y0 - e - R + s
// and column c of sV <-> image column X0 - e - R + c, both clamped into the
// image; the tile needs staged rows [0, TH + 2R) and columns [0, TW + 2R).
// Row chunk j owns rows [TH + 2R - (j + 1) cr, TH + 2R - j cr) (clipped at
// 0) and stages them and the OVR rows above; column chunk j owns columns
// likewise and computes sV's columns and the OVC columns left of them. A
// tile needs no chunks up to R 32 (3 blocks an SM at r 16, 2 at r 32).
struct Plan {
  int R;
  int nb;     // blocks of KB taps the padded taps fill: ceil((2R + 1) / KB)
  int srows;  // staged rows a row chunk holds at most (sM's rows)
  int cr;     // rows a row chunk owns
  int nrc;    // row chunks
  int vcols;  // columns a column chunk computes at most
  int cw;     // columns a column chunk owns
  int ncc;    // column chunks
};

// sM's rows, sV, and with column chunks the horizontal sums between them.
__host__ __device__ constexpr int plan_floats(int srows, bool chunked) {
  return srows * PM + TH * PV + (chunked ? TH * OP : 0);
}

inline Plan make_plan(int R) {
  Plan p;
  p.R = R;
  p.nb = (2 * R + KB) / KB;
  const int rows = TH + 2 * R, cols = TW + 2 * R;
  p.vcols = cols < CHUNK_COLS ? cols : CHUNK_COLS;
  p.cw = p.vcols == cols ? cols : p.vcols - OVC;
  const int rcap = (CAP_BYTES / (int)sizeof(float)
                    - plan_floats(0, p.cw < cols)) / PM;
  p.srows = rows < rcap ? rows : rcap;
  p.cr = p.srows == rows ? rows : p.srows - OVR;
  p.nrc = (rows + p.cr - 1) / p.cr;
  p.ncc = (cols + p.cw - 1) / p.cw;
  return p;
}

inline int smem_bytes(const Plan& p) {
  return (int)sizeof(float) * plan_floats(p.srows, p.ncc > 1);
}

// --------------------------------------------------------- the staging -- //
template <class T, bool HWC>
__device__ __forceinline__ float max_rgb(const T* __restrict__ in, int b,
                                         int y, int x, int H, int W) {
  if constexpr (HWC) {
    const T* p = in + (((size_t)b * H + y) * W + x) * 3;
    return fmaxf(fmaxf(load_px(p), load_px(p + 1)), load_px(p + 2));
  } else {
    const size_t plane = (size_t)H * W;
    const T* p = in + (size_t)b * 3 * plane + (size_t)y * W + x;
    return fmaxf(fmaxf(load_px(p), load_px(p + plane)),
                 load_px(p + 2 * plane));
  }
}

// A staged group's loads, issued a batch of groups ahead of their use (a
// warp issues in order: the first use of a loaded register waits for it):
// the words or floats under max RGB of the pixels (y, x .. x + 3) where
// the group lies inside the image, else its four maxima from each pixel's
// clamped column.
struct Raw {
  uint32_t r[12];
  bool inside;
};

template <class T, bool HWC>
__device__ __forceinline__ void load_group(const T* __restrict__ in, int b,
                                           int y, int x, int H, int W,
                                           Raw& a) {
  a.inside = x >= 0 && x + 3 < W;
  if (!a.inside) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a.r[q] = __float_as_uint(
          max_rgb<T, HWC>(in, b, y, clampi(x + q, 0, W - 1), H, W));
    return;
  }
  if constexpr (sizeof(T) == 1) {
    // the aligned words under the group's bytes (a word holding a byte of
    // an allocation lies inside it); r[4] / r[9..11] their shifts
    if constexpr (HWC) {
      const uintptr_t p = (uintptr_t)in + (((size_t)b * H + y) * W + x) * 3;
      const uint32_t* w = (const uint32_t*)(p & ~(uintptr_t)3);
      a.r[4] = 8 * (uint32_t)(p & 3);
#pragma unroll
      for (int k = 0; k < 3; ++k) a.r[k] = w[k];
      a.r[3] = a.r[4] ? w[3] : 0u;
    } else {
      const size_t plane = (size_t)H * W;
      const uintptr_t p = (uintptr_t)in + (size_t)b * 3 * plane
                          + (size_t)y * W + x;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uintptr_t pk = p + k * plane;
        const uint32_t* w = (const uint32_t*)(pk & ~(uintptr_t)3);
        a.r[9 + k] = 8 * (uint32_t)(pk & 3);
        a.r[2 * k] = w[0];
        a.r[2 * k + 1] = a.r[9 + k] ? w[1] : 0u;
      }
    }
  } else {
    float f[12];
    if constexpr (HWC) {
      const float* p = (const float*)in + (((size_t)b * H + y) * W + x) * 3;
      if (((uintptr_t)p & 15) == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 v = ((const float4*)p)[k];
          f[4 * k] = v.x;
          f[4 * k + 1] = v.y;
          f[4 * k + 2] = v.z;
          f[4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) f[k] = p[k];
      }
    } else {
      const size_t plane = (size_t)H * W;
      const float* p = (const float*)in + (size_t)b * 3 * plane
                       + (size_t)y * W + x;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* pk = p + k * plane;
        tile::load_plane(pk, 0, 4, ((uintptr_t)pk & 15) == 0, f + 4 * k);
      }
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) a.r[k] = __float_as_uint(f[k]);
  }
}

// The group's max RGB from its loads: on u8 the bytes' max four at a time
// (__vmaxu4), then one conversion a pixel (the conversion is exact and
// increasing, so this is the max of the converted values).
template <class T, bool HWC>
__device__ __forceinline__ void max_group(const Raw& a, float v[4]) {
  if (!a.inside) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __uint_as_float(a.r[q]);
    return;
  }
  if constexpr (sizeof(T) == 1) {
    uint32_t mx;
    if constexpr (HWC) {
      // 12 bytes r g b r g b ...: each channel's 4 bytes into a word
      const uint32_t sh = a.r[4];
      const uint32_t u0 = __funnelshift_r(a.r[0], a.r[1], sh),
                     u1 = __funnelshift_r(a.r[1], a.r[2], sh),
                     u2 = __funnelshift_r(a.r[2], a.r[3], sh);
      const uint32_t r = __byte_perm(__byte_perm(u0, u1, 0x0630u), u2,
                                     0x5210u);
      const uint32_t g = __byte_perm(__byte_perm(u0, u1, 0x0741u), u2,
                                     0x6210u);
      const uint32_t bl = __byte_perm(__byte_perm(u0, u1, 0x0052u), u2,
                                      0x7410u);
      mx = __vmaxu4(__vmaxu4(r, g), bl);
    } else {
      uint32_t c[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[k] = __funnelshift_r(a.r[2 * k], a.r[2 * k + 1], a.r[9 + k]);
      mx = __vmaxu4(__vmaxu4(c[0], c[1]), c[2]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = tile::u8_at(mx, q);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float c[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[k] = __uint_as_float(HWC ? a.r[3 * q + k] : a.r[4 * k + q]);
      v[q] = fmaxf(fmaxf(c[0], c[1]), c[2]);
    }
  }
}

// Staged rows [s0, s1) and sV's columns [c0, c1) of the tile into sM (row
// s - s0, column c - c0), 4 columns a thread an item, a batch of items'
// loads in flight at once; ry and cx are the image row and column of
// staged row 0 and column 0.
template <class T, bool HWC>
__device__ inline void stage(const T* __restrict__ in, float* __restrict__ sM,
                             int b, int H, int W, int ry, int cx, int s0,
                             int s1, int c0, int c1, int tid) {
  // items a batch: as many as the form's loads fit in registers beside
  // the addresses (u8 HWC 5 words an item, u8 planar 9, f32 12)
  constexpr int NB = sizeof(T) == 1 ? (HWC ? 4 : 2) : (HWC ? 2 : 1);
  const int ng = (c1 - c0 + 3) >> 2;
  const int n = s1 - s0;
  int i = tid / ng, g = tid - i * ng;
  const int di = NT / ng, dg = NT - di * ng;
  while (i < n) {
    Raw a[NB];
    int at[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      at[j] = i < n ? i * PM + 4 * g : -1;
      if (i < n)
        load_group<T, HWC>(in, b, clampi(ry + s0 + i, 0, H - 1),
                           cx + c0 + 4 * g, H, W, a[j]);
      g += dg;
      i += di;
      if (g >= ng) {
        g -= ng;
        ++i;
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (at[j] < 0) continue;
      float v[4];
      max_group<T, HWC>(a[j], v);
      *(float4*)(sM + at[j]) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ----------------------------------------------------------- the sums -- //
// One tap block: K taps from `tp` added to the N sums of a strip or
// segment in order. Output o's term u reads window entry K - 1 + o - u,
// entry i at src[i * step]; the window ends at the block's anchor (entry
// N + K - 2), the last row (column) that its first tap reads.
template <int N, int K, int STEP>
__device__ __forceinline__ void tap_block(float (&acc)[N],
                                          const float* __restrict__ src,
                                          const float* __restrict__ tp) {
  constexpr int NW = N + K - 1;
  float t[K];
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K / 4; ++k) {
      const float4 f = __ldg((const float4*)tp + k);
      t[4 * k] = f.x;
      t[4 * k + 1] = f.y;
      t[4 * k + 2] = f.z;
      t[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = __ldg(tp + k);
  }
  float w[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = src[i * STEP];
#pragma unroll
  for (int u = 0; u < K; ++u)
#pragma unroll
    for (int o = 0; o < N; ++o) acc[o] = acc[o] + t[u] * w[K - 1 + o - u];
}

// The 2R + 1 taps as blocks of KB, then the rest as one block each of 8,
// 4, 2 and 1 where the rest has that bit, in tap order; tap k's block
// anchor is base - k. Each block whose anchor lies in [lo, hi) is added,
// its window read from src0 + (row - origin) * STEP.
template <int N, int K, int STEP>
__device__ __forceinline__ void rest_block(float (&acc)[N], const float* src0,
                                           int base, int lo, int hi,
                                           int origin, int rest, int& k,
                                           const float* __restrict__ taps) {
  if (!(rest & K)) return;
  const int anchor = base - k;
  if (anchor >= lo && anchor < hi)
    tap_block<N, K, STEP>(acc, src0 + (anchor - (N + K - 2) - origin) * STEP,
                          taps + k);
  k += K;
}

template <int N, int STEP>
__device__ __forceinline__ void blocks(float (&acc)[N], const float* src0,
                                       int base, int lo, int hi, int origin,
                                       int R, const float* __restrict__ taps) {
  const int nfull = (2 * R + 1) / KB;
  const int n0 = base < hi ? 0 : (base - hi) / KB + 1;
  const int n1 = base < lo ? -1 : min((base - lo) / KB, nfull - 1);
  for (int n = n0; n <= n1; ++n) {
    const int anchor = base - n * KB;
    tap_block<N, KB, STEP>(
        acc, src0 + (anchor - (N + KB - 2) - origin) * STEP, taps + n * KB);
  }
  int k = nfull * KB;
  const int rest = 2 * R + 1 - k;
  rest_block<N, 8, STEP>(acc, src0, base, lo, hi, origin, rest, k, taps);
  rest_block<N, 4, STEP>(acc, src0, base, lo, hi, origin, rest, k, taps);
  rest_block<N, 2, STEP>(acc, src0, base, lo, hi, origin, rest, k, taps);
  rest_block<N, 1, STEP>(acc, src0, base, lo, hi, origin, rest, k, taps);
}

// Pass 2 on the row chunk owning staged rows [lo, hi) (staged from row s0):
// each (column, strip) item's sums, from -0 in the first row chunk, else
// from sV; back into sV's rows t0 .. t0 + VS - 1.
__device__ inline void vertical(const float* __restrict__ sM,
                                float* __restrict__ sV, const Plan& p,
                                const float* __restrict__ taps, int s0,
                                int lo, int hi, int nc, bool first, int tid) {
  for (int it = tid; it < nc * NSTRIP; it += NT) {
    const int q = it / nc, c = it - q * nc;
    const int t0 = q * VS;
    float* vp = sV + t0 * PV + c;
    float acc[VS];
#pragma unroll
    for (int o = 0; o < VS; ++o) acc[o] = first ? -0.0f : vp[o * PV];
    blocks<VS, PM>(acc, sM + c, t0 + VS - 1 + 2 * p.R, lo, hi, s0, p.R,
                   taps);
#pragma unroll
    for (int o = 0; o < VS; ++o) vp[o * PV] = acc[o];
  }
}

// ------------------------------------------------------------ the tile -- //
// The plane L (B, H + 2e, W + 2e) of the (B, H, W, 3) image (HWC) or the
// (B, 3, H, W) block: grid (Y, X) <-> pixel (Y - e, X - e), reads clamped
// into the image. taps: nb * KB floats, 16-byte aligned, zero past 2R.
template <class T, bool HWC>
__global__ void __launch_bounds__(NT, 3)
blur_tile_kernel(const T* __restrict__ in, float* __restrict__ out, int H,
                 int W, int e, const float* __restrict__ taps,
                 const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                 // staged rows; at the end the output
  float* sV = smem + p.srows * PM;  // the vertical sums
  float* sH = sV + TH * PV;         // the horizontal sums between chunks
  const int tid = threadIdx.x;
  const int b = blockIdx.z, Y0 = blockIdx.y * TH, X0 = blockIdx.x * TW;
  const int R = p.R, NR = TH + 2 * R, NC = TW + 2 * R;
  const int ry = Y0 - e - R, cx = X0 - e - R;
  const int ht = tid & 31, hx = (tid >> 5) * HS;  // the segment's row, column
  for (int cc = 0; cc < p.ncc; ++cc) {
    const int chi = NC - cc * p.cw, clo = max(chi - p.cw, 0);
    const int c0 = max(clo - OVC, 0);
    for (int rc = 0; rc < p.nrc; ++rc) {
      const int rhi = NR - rc * p.cr, rlo = max(rhi - p.cr, 0);
      const int s0 = max(rlo - OVR, 0);
      stage<T, HWC>(in, sM, b, H, W, ry, cx, s0, rhi, c0, chi, tid);
      __syncthreads();
      vertical(sM, sV, p, taps, s0, rlo, rhi, chi - c0, rc == 0, tid);
      __syncthreads();
    }
    // the segment's sums: from -0, or from sH after an earlier chunk; into
    // sH before a later one, else into the output tile (sM, free now)
    float acc[HS];
    float4* h = (float4*)(sH + ht * OP + hx);
#pragma unroll
    for (int k = 0; k < HS / 4; ++k) {
      const float4 v = cc ? h[k] : make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
      acc[4 * k] = v.x;
      acc[4 * k + 1] = v.y;
      acc[4 * k + 2] = v.z;
      acc[4 * k + 3] = v.w;
    }
    blocks<HS, 1>(acc, sV + ht * PV, hx + HS - 1 + 2 * R, clo, chi, c0, R,
                  taps);
    float4* d = cc + 1 < p.ncc ? h : (float4*)(sM + ht * OP + hx);
#pragma unroll
    for (int k = 0; k < HS / 4; ++k)
      d[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                         acc[4 * k + 3]);
  }
  __syncthreads();

  // out: the tile's rows from sM, TW / 4 lanes a row, a float4 a lane
  // (float2 or scalars where the row is not 16-byte aligned or ends)
  constexpr int LR = TW / 4;
  const int HE = H + 2 * e, WE = W + 2 * e;
  const int f = 4 * (tid % LR);
  for (int r = tid / LR; r < TH && Y0 + r < HE; r += NT / LR) {
    const float4 v = *(const float4*)(sM + r * OP + f);
    float* q = out + ((size_t)b * HE + Y0 + r) * WE + X0 + f;
    const uintptr_t a = (uintptr_t)q;
    if (X0 + f + 4 <= WE && (a & 7) == 0) {
      if ((a & 15) == 0) {
        *(float4*)q = v;
      } else {
        ((float2*)q)[0] = make_float2(v.x, v.y);
        ((float2*)q)[1] = make_float2(v.z, v.w);
      }
    } else {
      const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (X0 + f + k < WE) q[k] = u[k];
    }
  }
}

template <class T, bool HWC>
const void* kernel_of() {
  return (const void*)blur_tile_kernel<T, HWC>;
}

// The form's kernel: 2 * f32 + hwc.
inline const void* form_kernel(int form) {
  switch (form) {
    case 0: return kernel_of<uint8_t, false>();
    case 1: return kernel_of<uint8_t, true>();
    case 2: return kernel_of<float, false>();
    case 3: return kernel_of<float, true>();
    default: return nullptr;
  }
}

template <class T, bool HWC>
int launch(const void* in, float* l, int B, int H, int W, int e,
           const float* taps, const Plan& p, cudaStream_t st) {
  const int smem = smem_bytes(p);
  // the opt-in holds for the device current when it is set: every launch
  if (const cudaError_t err = cudaFuncSetAttribute(
          blur_tile_kernel<T, HWC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)err;
  const dim3 grid((W + 2 * e + TW - 1) / TW, (H + 2 * e + TH - 1) / TH, B);
  blur_tile_kernel<T, HWC><<<grid, NT, smem, st>>>((const T*)in, l, H, W, e,
                                                   taps, p);
  return (int)cudaGetLastError();
}

}  // namespace blur
}  // namespace llie

using namespace llie;

extern "C" {

// The blurred illumination of a radius past MAX_BLUR_RADIUS: `in` the
// (B, H, W, 3) image (`hwc` 1) or the (B, 3, H, W) block, u8 or (`f32` 1)
// f32; l the (B, H + 2e, W + 2e) plane; `taps` the radius's
// gaussian_kernel_1d on the device, 16-byte aligned and zero-padded to
// llie_blur_plan(radius, 0, 9) floats.
int llie_blur_illumination(const void* in, int f32, int hwc, float* l, int B,
                           int H, int W, int e, int radius, const float* taps,
                           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || e < 0 || radius < 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)taps & 15) != 0) return (int)cudaErrorInvalidValue;
  const blur::Plan p = blur::make_plan(radius);
  const cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return hwc ? blur::launch<float, true>(in, l, B, H, W, e, taps, p, st)
               : blur::launch<float, false>(in, l, B, H, W, e, taps, p, st);
  return hwc ? blur::launch<uint8_t, true>(in, l, B, H, W, e, taps, p, st)
             : blur::launch<uint8_t, false>(in, l, B, H, W, e, taps, p, st);
}

// The blur kernel's plan at a radius: `what` 0 shared memory bytes, 1 the
// staged rows a row chunk holds, 2 the rows it owns, 3 row chunks, 4 the
// columns a column chunk computes, 5 the columns it owns, 6 column chunks,
// 7 and 8 the pitches of the staged rows and of the vertical sums, 9 the
// taps' floats (tap blocks of 16), 10 the tile's rows, 11 its columns, 12
// threads a block; and of the form's kernel (`form` 2 * f32 + hwc) on the
// device current now: 13 registers a thread, 14 local memory a thread in
// bytes (stack and spills), 15 blocks an SM at the plan's shared memory
// (the occupancy API). -1 for an argument out of range.
int llie_blur_plan(int radius, int form, int what) {
  if (radius < 1 || form < 0 || form > 3) return -1;
  const blur::Plan p = blur::make_plan(radius);
  switch (what) {
    case 0: return blur::smem_bytes(p);
    case 1: return p.srows;
    case 2: return p.cr;
    case 3: return p.nrc;
    case 4: return p.vcols;
    case 5: return p.cw;
    case 6: return p.ncc;
    case 7: return blur::PM;
    case 8: return blur::PV;
    case 9: return p.nb * blur::KB;
    case 10: return blur::TH;
    case 11: return blur::TW;
    case 12: return blur::NT;
    default: break;
  }
  const void* kern = blur::form_kernel(form);
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kern) != cudaSuccess) return -1;
  switch (what) {
    case 13: return fa.numRegs;
    case 14: return (int)fa.localSizeBytes;
    case 15: {
      const int smem = blur::smem_bytes(p);
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, blur::NT,
                                                        smem) != cudaSuccess)
        return -1;
      return n;
    }
    default: return -1;
  }
}

}  // extern "C"
