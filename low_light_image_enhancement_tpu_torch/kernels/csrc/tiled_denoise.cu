// K5, the tiled denoise tail for Hopper (sm_90a), bound to PyTorch through
// ctypes (kernels/tiled_denoise.py).
//
// What it replaces. The TPU kernel tiled_denoise -> _denoise_kernel
// (low_light_image_enhancement_tpu/kernels/tiled_denoise.py): the denoise
// tail of the fcn and decom methods on an f32 block, bilateral (separable or
// full 3x3, exp or epan range weight, per channel or luma-joint) or guided
// (radius r, eps, per channel or luma-joint), blended by strength and
// clipped to [0, 1].
//
// Window contract. The input is the whole f32 block (B, 3, HB, WB); the
// output (B, 3, rows, WB) holds block rows [halo, halo + rows). The kernel
// reads the window [halo - m, halo + rows + m) where it lies, with row reads
// clamped into it and column reads clamped into [0, WB). The TPU kernel
// copies that window out and wraps inside it instead; since the margin m
// covers the tail's receptive radius (1 for the bilateral, 2r for the
// guided cascade), no pixel a caller keeps (every row, columns [m, m + w))
// reads a clamped or wrapped value, and the two agree there.
//
// What bounds it. Data is read once and written once: 12 bytes in and 12
// out per pixel, plus the halo rows. The guided cascade at r = 4 does some
// 300 float operations per pixel (14 box means of 4r + 1 adds and a
// multiply, and the a / b algebra), the bilateral up to ~250 with 27 exps:
// at the H100's 67 TFLOP/s of f32 against 3.35 TB/s that is below the
// ~20 operations per byte where arithmetic would bound it, so device
// memory bounds K5 on paper.
//
// What the design does about it. The bilateral arms run on the tile engine
// of K1, K3 and K4 (retinex_tile.cuh) with no blur: a 32 x 64 output tile
// a block of 256 threads, the three planes staged with their one-pixel
// ring in 4-pixel groups (a float4 where the group is inside the row and
// aligned, else each value at its clamped column), then the engine's tail
// (pass 1 in column strips, pass 2 or the full 3x3 in row segments of 8,
// one range weight a neighbour pair, the centre's weight once a thread),
// clipped, and stored from shared memory as whole output rows, half a warp
// a row (float4, or scalars where a row is unaligned). The guided arms
// (guided.cuh): a 32 x 32 tile of 256 threads, its input with a 2r ring
// staged once (and the joint guide beside it); every box mean runs as a
// vertical and a horizontal pass of items of 8 outputs, each summed in
// registers from the 8 + 2r values under it, so shared memory is read
// about twice a value and pass at r = 4 rather than 2r + 1 times, with
// about 13 barriers a tile rather than 33; the algebra runs in the
// horizontal items' registers, and the blended tile leaves through shared
// memory in whole rows. The radius and the guide are template parameters
// (8 radii x joint / per channel), so every window index is a constant.
// The staging writes the joint guide beside the input, and the blended
// tile replaces the input's centre: a tile at r = 4 holds 90 KB of shared
// memory with the joint guide (two blocks an SM), 67.5 KB per channel
// (three), at r = 8 125 KB: the launch opts in to dynamic shared memory
// past 48 KB (cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// Numerics. --fmad=false and no --use_fast_math (see _build.py); the
// device code repeats the plain versions' operations in their order
// (retinex_tile.cuh's tail for the bilateral, guided.cuh for the guided
// filter).
#include "guided.cuh"
#include "retinex_tile.cuh"

namespace llie {

// Bilateral arms on the tile engine: the tile's output rows [y0, y0 + TH)
// are block rows halo + y0 .., so ring row i <-> block row halo + y0 - 1 +
// i, read clamped into the window [halo - m, halo + rows + m), and ring
// column j <-> block column x0 - 1 + j, clamped into [0, WB). Shared
// memory: the three ring planes, then pass 1's planes (K4's without its
// blur phase and its u8 words). Built for 3 blocks an SM.
constexpr int K5_SMEM_BYTES =
    (int)sizeof(float)
    * (3 * tile::ring_plane(0) + 3 * tile::TH * tile::pitch(0));

__global__ void __launch_bounds__(tile::NT, 3)
denoise_bilateral_kernel(const float* __restrict__ in, float* __restrict__ out,
                         int HB, int WB, int halo, int rows, int m,
                         const __grid_constant__ TailParams tp) {
  using namespace tile;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const Geo g = make_geo(0, x0, halo + y0);
  const size_t plane = (size_t)HB * WB;
  const float* blk = in + (size_t)b * 3 * plane;
  float* sY = smem;             // 3 ring planes
  float* sP = smem + 3 * g.YP;  // pass 1: 3 x TH rows
  const int lo = halo - m, hi = halo + rows + m - 1;

  // 1. staging: the ring of each plane, 4-pixel groups, each a float4
  // where it lies inside the row on a 16-byte boundary
  const bool aligned = (WB & 3) == 0 && ((uintptr_t)in & 15) == 0;
  auto load = [&](int i, int gi, RawPlanes& a) {
    const size_t row = (size_t)clampi(g.ya + i, lo, hi) * WB;
    const int x = g.xa + 4 * gi;
    const bool words = aligned && x >= 0 && x + 4 <= WB;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_plane(blk + c * plane + row, x, WB, words, a.r + 4 * c);
  };
  // every item's loads first (NI a thread), then their stores
  constexpr int NG = groups(0), NI = (YH * NG + NT - 1) / NT;
  RawPlanes a[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int it = tid + k * NT;
    if (it < YH * NG) load(it / NG, it % NG, a[k]);
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int it = tid + k * NT;
    if (it >= YH * NG) continue;
    const int i = it / NG, j = 4 * (it % NG);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sY[c * g.YP + i * g.P + j + q] = __uint_as_float(a[k].r[4 * c + q]);
  }
  __syncthreads();

  // 2. the tail
  Outs o;
  tail(sY, sP, g, tp, true, tid, o);

  // 3. out: the clipped tile into shared memory over pass 1's planes, from
  // the first 16-byte boundary there (a float4 of a row a lane; pitch OP
  // puts 8 lanes' rows on 32 banks), then whole rows, half a warp a row, a
  // float4 a lane (scalars where a row is not 16-byte aligned or ends)
  constexpr int OP = TW + 4, RING = 3 * ring_plane(0);
  static_assert((RING + 3) / 4 * 4 + 3 * TH * OP <= RING + 3 * TH * pitch(0),
                "the tile in sP's place");
  float* sO = smem + (RING + 3) / 4 * 4;
  __syncthreads();
  {
    const int t = tid & 31, c0 = (tid >> 5) * K2;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int k = 0; k < K2 / 4; ++k)
        *(float4*)(sO + (ch * TH + t) * OP + c0 + 4 * k) =
            make_float4(clip01(o.v[4 * k][ch]), clip01(o.v[4 * k + 1][ch]),
                        clip01(o.v[4 * k + 2][ch]),
                        clip01(o.v[4 * k + 3][ch]));
  }
  __syncthreads();
  const int f = 4 * (tid & 15);
  for (int rr = tid >> 4; rr < 3 * TH; rr += NT / 16) {
    const int ch = rr / TH, t = rr % TH;
    if (y0 + t >= rows) continue;
    const float4 v = *(const float4*)(sO + rr * OP + f);
    float* q = out + (((size_t)b * 3 + ch) * rows + y0 + t) * WB + x0 + f;
    if (x0 + f + 4 <= WB && ((uintptr_t)q & 15) == 0) {
      *(float4*)q = v;
    } else {
      const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + f + k < WB) q[k] = u[k];
    }
  }
}

// Guided arms: the input tile with a 2r ring, then guided_tile, then the
// clipped tile out.
template <int R, bool JOINT>
__global__ void __launch_bounds__(GUIDED_THREADS)
denoise_guided_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int HB, int WB, int halo, int rows, int m,
                      GuidedParams gp) {
  using Gm = GuidedGeom<R>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * GT_H, x0 = blockIdx.x * GT_W;
  const size_t plane = (size_t)HB * WB;
  const float* blk = in + (size_t)blockIdx.z * 3 * plane;
  const int lo = halo - m, hi = halo + rows + m - 1;
  const int r0 = halo + y0 - 2 * R, c0 = x0 - 2 * R;

  for (int e = tid; e < Gm::LH * Gm::LW; e += GUIDED_THREADS) {
    const int i = e / Gm::LW, j = e % Gm::LW;
    const size_t at = (size_t)clampi(r0 + i, lo, hi) * WB
                      + clampi(c0 + j, 0, WB - 1);
    float v[3];
    for (int c = 0; c < 3; ++c) {
      v[c] = blk[c * plane + at];
      smem[c * Gm::LN + i * Gm::LS + j] = v[c];
    }
    if (JOINT) smem[3 * Gm::LN + i * Gm::LS + j] = guide_of(v[0], v[1], v[2]);
  }
  __syncthreads();

  guided_tile<R, JOINT>(smem, gp, tid);
  float* q = out + (size_t)blockIdx.z * 3 * rows * WB;
  for (int e = tid; e < GT_H * GT_W; e += GUIDED_THREADS) {
    const int i = e / GT_W, j = e % GT_W;
    const int r = y0 + i, c = x0 + j;
    if (r < rows && c < WB)
      for (int ch = 0; ch < 3; ++ch)
        q[(size_t)ch * rows * WB + (size_t)r * WB + c] =
            clip01(at_out<R>(smem, ch, i, j));
  }
}

template <int R, bool JOINT>
int launch_guided(const float* in, float* out, int B, int HB, int WB,
                  int halo, int rows, int m, const GuidedParams& gp,
                  cudaStream_t stream) {
  const int smem = (int)sizeof(float) * GuidedGeom<R>::floats(JOINT);
  const void* kern = (const void*)denoise_guided_kernel<R, JOINT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((WB + GT_W - 1) / GT_W, (rows + GT_H - 1) / GT_H, B);
  denoise_guided_kernel<R, JOINT><<<grid, GUIDED_THREADS, smem, stream>>>(
      in, out, HB, WB, halo, rows, m, gp);
  return (int)cudaGetLastError();
}

template <int R>
int launch_guided_r(const float* in, float* out, int B, int HB, int WB,
                    int halo, int rows, int m, const GuidedParams& gp,
                    cudaStream_t stream) {
  return gp.joint
             ? launch_guided<R, true>(in, out, B, HB, WB, halo, rows, m, gp,
                                      stream)
             : launch_guided<R, false>(in, out, B, HB, WB, halo, rows, m, gp,
                                       stream);
}

}  // namespace llie

using namespace llie;

extern "C" {

// f32 block (B, 3, HB, WB) -> f32 (B, 3, rows, WB), output row r <-> block
// row halo + r. `guided` selects the guided arms (radius g_radius, box
// factor g_k, eps g_eps; `joint` picks the luma guide), else the bilateral
// arms of TailParams. Returns cudaGetLastError() after the launch (0 when
// it was accepted).
int llie_tiled_denoise_f32(const void* in, void* out, int B, int HB, int WB,
                           int halo, int rows, int m, float strength,
                           float inv2s2, float inv2s2_3, int kind, int joint,
                           int sep, int guided, int g_radius, float g_k,
                           float g_eps, void* stream) {
  if (rows < 1 || halo < m || HB < halo + rows + m || WB < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* fin = (const float*)in;
  float* fout = (float*)out;
  if (guided) {
    if (g_radius < 1 || g_radius > MAX_GUIDED_RADIUS || 2 * g_radius > m)
      return (int)cudaErrorInvalidValue;
    GuidedParams gp;
    gp.radius = g_radius;
    gp.k = g_k;
    gp.eps = g_eps;
    gp.strength = strength;
    gp.joint = joint;
    switch (g_radius) {
#define LLIE_GUIDED_CASE(R) \
  case R:                   \
    return launch_guided_r<R>(fin, fout, B, HB, WB, halo, rows, m, gp, st);
      LLIE_GUIDED_CASE(1)
      LLIE_GUIDED_CASE(2)
      LLIE_GUIDED_CASE(3)
      LLIE_GUIDED_CASE(4)
      LLIE_GUIDED_CASE(5)
      LLIE_GUIDED_CASE(6)
      LLIE_GUIDED_CASE(7)
      LLIE_GUIDED_CASE(8)
#undef LLIE_GUIDED_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    if (m < 1) return (int)cudaErrorInvalidValue;
    const TailParams tp =
        tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
    // the engine's shared-memory opt-in, before every launch
    if (const int e = tile::prepare(denoise_bilateral_kernel)) return e;
    const dim3 grid((WB + tile::TW - 1) / tile::TW,
                    (rows + tile::TH - 1) / tile::TH, B);
    denoise_bilateral_kernel<<<grid, tile::NT, K5_SMEM_BYTES, st>>>(
        fin, fout, HB, WB, halo, rows, m, tp);
  }
  return (int)cudaGetLastError();
}

// K5's bilateral kernel on the device current now: `what` 0 its registers
// a thread, 1 its local memory a thread in bytes (stack and spills), 2 its
// dynamic shared memory in bytes, 3 the blocks an SM at that shared memory
// (the occupancy API). -1 for an argument out of range.
int llie_tiled_denoise_bilateral_plan(int what) {
  const void* kern = (const void*)denoise_bilateral_kernel;
  if (what == 2) return K5_SMEM_BYTES;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kern) != cudaSuccess) return -1;
  switch (what) {
    case 0: return fa.numRegs;
    case 1: return (int)fa.localSizeBytes;
    case 3: {
      if (tile::prepare(denoise_bilateral_kernel) != cudaSuccess) return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kern, tile::NT, K5_SMEM_BYTES) != cudaSuccess)
        return -1;
      return n;
    }
    default: return -1;
  }
}

// K5's guided kernel of a radius and guide (`joint`) on the device current
// now: `what` 0 its registers a thread, 1 its local memory a thread in
// bytes (stack and spills), 2 its dynamic shared memory in bytes, 3 the
// blocks an SM at that shared memory (the occupancy API). -1 for an
// argument out of range.
int llie_tiled_denoise_guided_plan(int radius, int joint, int what) {
  if (radius < 1 || radius > MAX_GUIDED_RADIUS) return -1;
  const void* kern = nullptr;
  int smem = 0;
  switch (radius) {
#define LLIE_GUIDED_CASE(R)                                          \
  case R:                                                            \
    kern = joint ? (const void*)denoise_guided_kernel<R, true>       \
                 : (const void*)denoise_guided_kernel<R, false>;     \
    smem = (int)sizeof(float) * GuidedGeom<R>::floats(joint);        \
    break;
    LLIE_GUIDED_CASE(1)
    LLIE_GUIDED_CASE(2)
    LLIE_GUIDED_CASE(3)
    LLIE_GUIDED_CASE(4)
    LLIE_GUIDED_CASE(5)
    LLIE_GUIDED_CASE(6)
    LLIE_GUIDED_CASE(7)
    LLIE_GUIDED_CASE(8)
#undef LLIE_GUIDED_CASE
  }
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kern) != cudaSuccess) return -1;
  switch (what) {
    case 0: return fa.numRegs;
    case 1: return (int)fa.localSizeBytes;
    case 2: return smem;
    case 3: {
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kern, GUIDED_THREADS, smem) != cudaSuccess)
        return -1;
      return n;
    }
    default: return -1;
  }
}

}  // extern "C"
