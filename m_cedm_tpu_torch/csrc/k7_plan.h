// The bf16 K7's launch plan on its TMA route (csrc/fused_block.cu's
// unet_block_bf16_tma_kernel): the tile, the consumer warpgroups, the ring's
// stages, each phase's weights resident or streamed, and the shared memory's
// layout, as a function of the shape, the SMs and the blocks an SM. Plain
// C++ with no CUDA: fused_block.cu plans every launch with it, and a host
// compiler builds it alone, so the plan can be checked without a card:
//
//     c++ -std=c++17 -O1 -shared -fPIC -x c++ k7_plan.h -o libk7plan.so
//
// exports mc_unet_block_bf16_tma_plan and mc_unet_block_bf16_tma_shape.
#ifndef MC_K7_PLAN_H
#define MC_K7_PLAN_H

#ifdef __CUDACC__
#define K7_HD __host__ __device__
#else
#define K7_HD
#endif

namespace k7plan {

constexpr int kChunk = 64;              // channels a chunk: one 128-byte A row (bf16)
constexpr int kPixRow = 2 * kChunk;     // one position's 64 channels: a TMA row, bytes
constexpr int kTileW = 16;              // output columns a tile
constexpr int kHaloW = kTileW + 2;      // the halo'd tile's columns
constexpr int kMaxChannels = 256;       // xin channels (C1 + C2, each at most 128)
constexpr int kConvWBytes = 9 * kChunk * kPixRow;  // a conv chunk's weights, 73,728
constexpr int kProjWBytes = kChunk * kPixRow;      // a projection chunk's, 8,192
constexpr int kVecBytes = (2 * kChunk + 2 * kMaxChannels) * 4;  // bias, skip bias, scale, shift
constexpr int kSmemCapH = 232448;  // dynamic shared memory a block may take on the H100
constexpr int kBigTileWaves = 1;   // 16 x 16 tiles when they give this many a block
constexpr int kTmaStagesMax = 4;   // ring stages at most
constexpr int kMinStages = 2;      // ring stages at least
constexpr int kWideWG = 2;         // consumer warpgroups at 16 x 16 tiles
constexpr int kBigTileMinStages = 2;  // 16 x 16 tiles where this many stages fit
constexpr int kBarBytes = 256;     // the mbarriers

// A tile of kM * 8 rows x 16 pixels; its halo'd A stage's positions
K7_HD constexpr int rows_h(int km) { return 8 * km; }
K7_HD constexpr int pos_h(int km) { return (rows_h(km) + 2) * kHaloW; }
K7_HD constexpr int pad1k(int b) { return (b + 1023) & ~1023; }
// A ring stage's A part: the halo'd (8 kM + 2) x 18 tile, 128-byte rows
K7_HD constexpr int stage_t(int km) { return pad1k(pos_h(km) * kPixRow); }
// the output staging of all warpgroups: the tile's pixels, 128-byte rows
K7_HD constexpr int stg_t(int km) { return rows_h(km) * kTileW * kPixRow; }
// the up block's low-res residual under the tile
K7_HD constexpr int resbuf_t(int km) { return rows_h(km) / 2 * (kTileW / 2) * kPixRow; }

// The plan: tile rows 8 km, wg consumer warpgroups, the ring's stages, each
// phase's weights resident where they fit beside kMinStages stages (else
// streamed a chunk a step with its A stage), and the shared memory in this
// order: resident weights, the ring (A part padded to 1024 bytes, then the
// streamed weights' slot), the output staging rows, the up block's
// residual, bias / skip bias / scale / shift, the statistics' reduction,
// the barriers, and 1024 bytes for the plane's alignment. bps, sms and
// blocks: the grid.
struct PlanT {
  int km, wg, stages, res0, res1, smem, bps, sms, blocks, n_ob;
  int stage_bytes, ring_off, stg_off, rb_off, vec_off, red_off, bar_off;
};

// The layout of tile km with wg consumer warpgroups; false where not even
// kMinStages stages fit.
inline bool layout_t(int km, int wg, int all0, int all1, bool up_res, PlanT& pl) {
  const int a = stage_t(km);
  const int rest = stg_t(km) + (up_res ? resbuf_t(km) : 0) + kVecBytes + 2 * 4 * wg * kChunk * 4 +
                   kBarBytes + 1024;
  pl.km = km;
  pl.wg = wg;
  pl.res0 = all0 + kMinStages * a + rest <= kSmemCapH;
  pl.res1 = all1 + kMinStages * a + rest <= kSmemCapH;
  int fit = 0;
  for (int pass = 0; pass < 2 && fit < kMinStages; ++pass) {
    if (pass) pl.res0 = pl.res1 = 0;  // one phase's weights beside the other's slots: stream both
    pl.stage_bytes = a + (pl.res0 && pl.res1 ? 0 : kConvWBytes);
    const int w0b = pl.res0 ? all0 : 0, w1b = pl.res1 ? all1 : 0;
    pl.ring_off = w0b > w1b ? w0b : w1b;
    fit = (kSmemCapH - pl.ring_off - rest) / pl.stage_bytes;
  }
  if (fit < kMinStages) return false;
  pl.stages = fit < kTmaStagesMax ? fit : kTmaStagesMax;
  pl.stg_off = pl.ring_off + pl.stages * pl.stage_bytes;
  pl.rb_off = pl.stg_off + stg_t(km);
  pl.vec_off = pl.rb_off + (up_res ? resbuf_t(km) : 0);
  pl.red_off = pl.vec_off + kVecBytes;
  pl.bar_off = pl.red_off + 2 * 4 * wg * kChunk * 4;
  pl.smem = pl.bar_off + kBarBytes + 1024;
  return true;
}

// The TMA route by shape: C1, C2 and O multiples of 8 (TMA's 16-byte
// strides), and an identity skip with one input (its residual then comes
// from x alone)
inline bool tma_shape(int c1, int c2, int o, bool proj) {
  return c1 % 8 == 0 && c2 % 8 == 0 && o % 8 == 0 && (proj || c2 == 0);
}

// The tile and layout for an output (batch, h, wd, o) on sms SMs: 16 x 16
// tiles where they give every block one and both phases' weights stay
// resident beside kBigTileMinStages stages, else 8 x 16; false where
// nothing fits.
inline bool choose_t(bool up, int batch, int h, int wd, int c1, int c2, int o, bool proj,
                     int sms, PlanT& pl) {
  const int ncx = (c1 + kChunk - 1) / kChunk + (c2 + kChunk - 1) / kChunk;
  const int nch = (o + kChunk - 1) / kChunk;
  const int all0 = ncx * kConvWBytes, all1 = nch * kConvWBytes + (proj ? ncx * kProjWBytes : 0);
  const bool up_res = up && !proj;
  pl.sms = sms;
  pl.n_ob = nch;
  const long long tiles16 = (long long)batch * ((h + 15) / 16) * ((wd + kTileW - 1) / kTileW);
  const bool big = tiles16 * nch >= (long long)kBigTileWaves * sms &&
                   layout_t(2, kWideWG, all0, all1, up_res, pl) && pl.res0 && pl.res1 &&
                   pl.stages >= kBigTileMinStages;
  return big || layout_t(1, 2, all0, all1, up_res, pl);
}

// The grid at pl.bps blocks an SM: a multiple of the 64-output blocks, at
// most one block a tile of each; false where not one block each fits.
inline bool grid_t(int batch, int h, int wd, PlanT& pl) {
  const long long tiles = (long long)batch * ((h + rows_h(pl.km) - 1) / rows_h(pl.km)) *
                          ((wd + kTileW - 1) / kTileW);
  const long long cap = (long long)pl.bps * pl.sms / pl.n_ob;
  pl.blocks = (int)((tiles < cap ? tiles : cap) * pl.n_ob);
  return pl.blocks >= pl.n_ob;
}

}  // namespace k7plan

extern "C" {

// The plan of an output (batch, h, wd, o) on sms SMs at bps blocks an SM:
// out = {phase 0's weights resident, phase 1's, dynamic shared memory bytes,
// bps, sms, blocks, tile rows, ring stages, consumer warpgroups, a ring
// stage's bytes, ring_off, stg_off, rb_off, vec_off, red_off, bar_off}.
// Returns 0, 1 where no layout fits, 2 where the grid holds no block an
// output block.
int mc_unet_block_bf16_tma_plan(int batch, int h, int wd, int c1, int c2, int o, int up, int proj,
                                int sms, int bps, int* out) {
  k7plan::PlanT pl;
  if (!k7plan::choose_t(up != 0, batch, h, wd, c1, c2, o, proj != 0, sms, pl)) return 1;
  pl.bps = bps;
  const int rc = k7plan::grid_t(batch, h, wd, pl) ? 0 : 2;
  const int vals[16] = {pl.res0,     pl.res1,    pl.smem,   pl.bps,
                        pl.sms,      pl.blocks,  k7plan::rows_h(pl.km),
                        pl.stages,   pl.wg,      pl.stage_bytes,
                        pl.ring_off, pl.stg_off, pl.rb_off, pl.vec_off,
                        pl.red_off,  pl.bar_off};
  for (int i = 0; i < 16; ++i) out[i] = vals[i];
  return rc;
}

int mc_unet_block_bf16_tma_shape(int c1, int c2, int o, int proj) {
  return k7plan::tma_shape(c1, c2, o, proj != 0);
}

}  // extern "C"

#endif  // MC_K7_PLAN_H
