// The launch plan of K1's bf16 backward (csrc/fused_norm.cu's
// gn_silu_bwd_cluster_kernel): the blocks a sample, cut into thread-block
// clusters; the samples in flight; the rows a block takes and how many of
// them stay in shared memory between the two passes; the ring's stages; and
// the shared memory's layout, as a function of the shape, the SMs and the
// clusters of each size the card holds at once. Plain C++ with no CUDA:
// fused_norm.cu plans every bf16 launch with it, and a host compiler builds
// it alone, so the plan can be checked without a card:
//
//     c++ -std=c++17 -O1 -shared -fPIC -x c++ k1_bwd_plan.h -o libk1bwdplan.so
//
// exports mc_gn_silu_bwd_bf16_plan_for.
#ifndef MC_K1_BWD_PLAN_H
#define MC_K1_BWD_PLAN_H

#ifdef __CUDACC__
#define K1B_HD __host__ __device__
#else
#define K1B_HD
#endif

namespace k1bwd {

// the compute threads (and one producer warp beside them): 8 warps where a
// group's threads hold a row, up to 1024 channels; 16 above, up to 2048
constexpr int kNarrowConsumers = 256;
constexpr int kWideConsumers = 512;
constexpr int kGroups = 2;                 // groups that take alternate chunks
constexpr int kVec = 8;                    // channels a thread: one 16-byte bf16 vector
constexpr int kChunkBytes = 32768;         // x and g of a chunk of rows (at least one row)
constexpr int kBlocksPerSm = 1;
constexpr int kMinRows = 64;               // rows a block at least, where the sample has them
constexpr int kMaxBlocks = 128;            // blocks a sample at most
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kOneWave = 1;  // prefer the cluster size that takes the batch in fewest waves
constexpr int kSmemCap = 232448;           // dynamic shared memory one block may take (H100)
constexpr int kSmemBudget = kBlocksPerSm == 1 ? kSmemCap : 115712;
constexpr int kMaxC = 2048;

// The plan. A sample's `blocks` = cluster * clusters blocks each take a
// contiguous run of its rows (part_begin); `inflight` samples run at once
// (grid = inflight * blocks), and group i of them takes samples i, i +
// inflight, ... in that order. A block's rows come in chunks of
// `chunk_rows` through one ring of `slots` chunk slots; the last `slots`
// chunks of pass A stay in them for pass B, the others are read again.
// Where a sample spans clusters (clusters > 1), each cluster's sums go
// through `xchg_words` tagged 64-bit words of device memory.
struct Plan {
  int consumers, cluster, clusters, blocks, inflight, grid, waves;
  int rows, chunk_rows, chunks, slots;
  int lanes, row_slots, sets;
  int slot_bytes, data_off, red_off, part_off, tot_off, gstat_off, mm_off, vec_off, smem;
  long long xchg_words;
};

K1B_HD constexpr int round16(int b) { return (b + 15) & ~15; }
K1B_HD constexpr int round128(int b) { return (b + 127) & ~127; }

// The first row of part i of n rows cut into `parts` contiguous parts (none
// empty where parts <= n)
K1B_HD inline int part_begin(int i, int parts, int n) {
  return (int)((long long)i * n / parts);
}

// The compute threads of a call at C channels: the fewer where a group's
// threads hold a row
K1B_HD constexpr int consumers_for(int c) {
  return c / kVec <= kNarrowConsumers / kGroups ? kNarrowConsumers : kWideConsumers;
}

// A group's threads over 8-channel vectors: `lanes` a row, `row_slots` rows
// at once (threads past lanes * row_slots idle); a warp's slots summed by a
// butterfly where it holds whole slots, then `sets` partial sets in order
// (the warps, or each group's slots)
K1B_HD inline void lanes_of(int c, int consumers, int* lanes, int* row_slots, int* sets) {
  *lanes = c / kVec;
  *row_slots = consumers / kGroups / *lanes;
  *sets = (*lanes <= 32 && 32 % *lanes == 0) ? consumers / 32 : kGroups * *row_slots;
}

// The shared memory of a block that holds `slots` chunk slots: the
// mbarriers (full and empty a slot, then ready and done), the slots, the
// partial sets, the block's partial, the sample's sums, each group's mean
// and rstd, m1 and m2, then the sample's 4 C forward sums, sums of squares,
// gamma and beta; each region 16-byte aligned
K1B_HD inline int layout(Plan* p, int c, int groups) {
  p->data_off = round128(8 * (2 * p->slots + 2));
  p->red_off = p->data_off + p->slots * p->slot_bytes;
  p->part_off = p->red_off + round16(4 * p->sets * 2 * c);
  p->tot_off = p->part_off + round16(4 * 2 * c);
  p->gstat_off = p->tot_off + round16(4 * 2 * c);
  p->mm_off = p->gstat_off + round16(4 * 2 * groups);
  p->vec_off = p->mm_off + round16(4 * 2 * groups);
  p->smem = p->vec_off + round16(4 * 4 * c);
  return p->smem;
}

// The plan of a call, or false where the shape is not taken (C % 8, C past
// kMaxC, groups not dividing C). active[i]: the clusters of 2^i blocks (i <
// 4) the card holds at once at this kernel's shared memory.
inline bool plan(int batch, int n, int c, int groups, int sms, const int* active, Plan* p) {
  if (batch < 1 || n < 1 || c < kVec || c % kVec || c > kMaxC || groups < 1 || c % groups ||
      sms < 1)
    return false;
  // blocks a sample: a power of two that fills the SMs at one block an SM
  // over the batch, kMinRows rows a block at least, at most kMaxBlocks
  int want = sms / batch;
  if (want > kMaxBlocks) want = kMaxBlocks;
  if (want > n / kMinRows) want = n / kMinRows;
  int g = 1;
  while (2 * g <= want) g *= 2;
  for (; g >= 1; g /= 2) {
    int best = 0, best_waves = 0, best_inflight = 0;
    for (int cl = kMaxCluster, i = 3; cl >= 1; cl /= 2, --i) {
      if (cl > g || active[i] < 1) continue;
      const int k = g / cl;
      int inflight = active[i] / k;
      if (inflight > batch) inflight = batch;
      if (inflight < 1) continue;
      const int waves = (batch + inflight - 1) / inflight;
      if (!best || (kOneWave && waves < best_waves)) {
        best = cl;
        best_waves = waves;
        best_inflight = inflight;
      }
    }
    if (best) {
      p->cluster = best;
      p->clusters = g / best;
      p->blocks = g;
      p->inflight = best_inflight;
      p->grid = best_inflight * g;
      p->waves = best_waves;
      break;
    }
  }
  if (g < 1) return false;
  p->consumers = consumers_for(c);
  lanes_of(c, p->consumers, &p->lanes, &p->row_slots, &p->sets);
  if (p->row_slots < 1) return false;  // a row wider than a group's threads
  p->rows = (n + p->blocks - 1) / p->blocks;
  p->chunk_rows = kChunkBytes / (4 * c) > 0 ? kChunkBytes / (4 * c) : 1;
  if (p->chunk_rows > p->rows) p->chunk_rows = p->rows;
  p->chunks = (p->rows + p->chunk_rows - 1) / p->chunk_rows;
  p->slot_bytes = 4 * p->chunk_rows * c;  // x, then g, bf16
  // the slots that fit beside the fixed regions (a slot's two barriers
  // beside its bytes; 128 for the barriers' rounding), at most a chunk each.
  // Where the ring turns over, a multiple of kGroups: then a slot's
  // consecutive fills are chunks of one group, which has consumed the one
  // before when it waits for the next (a waiter that names the parity of a
  // phase two ahead of the barrier's would pass at once); and at least two
  // a group, since a group releases a pass-B slot only once the store out
  // of it has read it, after its next chunk.
  p->slots = 0;
  const int fit = (kSmemBudget - layout(p, c, groups) - 128) / (p->slot_bytes + 16);
  p->slots = p->chunks <= fit ? p->chunks : fit / kGroups * kGroups;
  if (p->slots < 1 || (p->chunks > p->slots && p->slots < 2 * kGroups)) return false;
  layout(p, c, groups);
  p->xchg_words = p->clusters > 1 ? (long long)batch * p->clusters * 2 * c : 0;
  return p->smem <= kSmemBudget;
}

}  // namespace k1bwd

#ifndef __CUDACC__
// The plan for the host's tests: out = {cluster, clusters, blocks, inflight,
// grid, waves, rows, chunk_rows, chunks, slots, lanes, row_slots, sets,
// slot_bytes, smem, xchg_words, consumers}; 0, or -1 where the shape is not
// taken
extern "C" int mc_gn_silu_bwd_bf16_plan_for(int batch, int n, int c, int groups, int sms,
                                            const int* active, long long* out) {
  k1bwd::Plan p;
  if (!k1bwd::plan(batch, n, c, groups, sms, active, &p)) return -1;
  const long long v[17] = {p.cluster, p.clusters, p.blocks, p.inflight, p.grid, p.waves,
                           p.rows, p.chunk_rows, p.chunks, p.slots, p.lanes, p.row_slots,
                           p.sets, p.slot_bytes, p.smem, p.xchg_words, p.consumers};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
  return 0;
}
#endif

#endif  // MC_K1_BWD_PLAN_H
