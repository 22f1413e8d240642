// graftscope: lock-free flight recorder for the native planes.
//
// Shared contract between the recorder (scope_core.cc), the instrumented
// planes (rpc_core.cc, copy_core.cc, store_server.cc) and the Python
// decoder (ray_tpu_torch/core/_native/graftscope.py). The wire record layout
// and the kind table below are lint-checked against the Python constants
// (tools/lint/wire_schema.py pass 3e) — keep both sides in sync.
//
// Wire record (little-endian, fixed width):
//   u8 kind | u8 op | u16 chan | u32 size | u64 seq_or_oid | u64 t_ns
//
// Span-in-one kinds carry their interval inside one record (no pairing
// needed across thread rings):
//   RpcFlush   : seq_or_oid = start_ns, t_ns = end_ns, size = bytes
//   CopyScatter: seq_or_oid = start_ns, t_ns = end_ns, size = bytes
//   ScEnd      : seq_or_oid = oid64,    t_ns = end_ns, size = dur_ns
// Point kinds timestamp a single instant (t_ns), with seq_or_oid
// carrying the frame seq (Rpc*) or the first 8 oid bytes (Sc*).

#ifndef RAY_TPU_SCOPE_CORE_H_
#define RAY_TPU_SCOPE_CORE_H_

#include <cstdint>

#pragma pack(push, 1)
struct ScopeWireRec {  // 24 bytes on the wire, little-endian
  uint8_t kind;
  uint8_t op;
  uint16_t chan;
  uint32_t size;
  uint64_t seq_or_oid;
  uint64_t t_ns;
};
#pragma pack(pop)

constexpr int kScopeRecordSize = 24;
static_assert(sizeof(ScopeWireRec) == kScopeRecordSize, "record packing");

// Record kinds. Mirrored by KIND_* in graftscope.py (lint pass 3e).
[[maybe_unused]] constexpr uint8_t kScopeRpcSend = 1, kScopeRpcRecv = 2,
                                   kScopeRpcFlush = 3, kScopeRpcWake = 4,
                                   kScopeCopyScatter = 5, kScopeCopyLink = 6,
                                   kScopeScAccept = 7, kScopeScBegin = 8,
                                   kScopeScEnd = 9, kScopeScRename = 10;
[[maybe_unused]] constexpr int kScopeKindCount = 11;  // 1 + highest kind

// Per-kind log2 latency histograms (graftpulse). Bucket b counts emits
// whose dur_ns landed in [2^(kScopeHistShift+b), 2^(kScopeHistShift+b+1)),
// with both tails clamped: bucket 0 also absorbs anything below
// 2^(kScopeHistShift+1) ns and the last bucket absorbs everything above.
// Mirrored by PULSE_HIST_* in graftpulse.py (lint pass 3f).
[[maybe_unused]] constexpr int kScopeHistBuckets = 16;
[[maybe_unused]] constexpr int kScopeHistShift = 10;  // bucket 0 ~= 1us

// graftpulse wire record: the fixed-size header of one node pulse,
// assembled by the node agent each tick and decoded by the controller
// (ray_tpu_torch/core/_native/graftpulse.py). The header is followed by
// kind_count * (3 + kScopeHistBuckets) little-endian u64s: per kind the
// {calls, bytes, ns} counter deltas then the histogram bucket deltas.
// Lint pass 3f keeps both sides in sync.
#pragma pack(push, 1)
struct PulseWireRec {  // 104 bytes on the wire, little-endian
  uint32_t magic;         // 'PLSE' = 0x45534c50
  uint16_t version;
  uint16_t kind_count;    // scope kinds in the trailing payload
  uint64_t seq;           // per-node pulse sequence number
  uint64_t t_mono_ns;     // scope_now_ns() at assembly
  uint64_t t_wall_ns;     // wall clock at assembly
  uint64_t store_used;
  uint64_t store_capacity;
  uint32_t store_objects;
  uint32_t shm_free_chunks;  // graftshm free-list depth
  uint64_t shm_arena_bytes;  // graftshm arena occupancy
  uint32_t num_workers;
  uint32_t queue_depth;      // leases queued + running across workers
  uint64_t rss_bytes;        // summed worker RSS
  uint64_t scope_dropped;
  uint64_t events_dropped;
  uint32_t prof_oncpu_permille;  // graftprof: worker on-CPU share, 0..1000
  uint32_t prof_gil_permille;    // graftprof: GIL-wait share, 0..1000
};
#pragma pack(pop)

// v2 appended the two graftprof permille gauges (was 96 bytes at v1).
// Widening this struct without bumping kPulseVersion is a lint error
// (pass 3f keeps a version -> size registry on both sides).
constexpr int kPulseRecordSize = 104;
static_assert(sizeof(PulseWireRec) == kPulseRecordSize, "pulse packing");
[[maybe_unused]] constexpr uint32_t kPulseMagic = 0x45534c50;
[[maybe_unused]] constexpr uint16_t kPulseVersion = 2;
// Version -> header size, one row per wire revision ever shipped.
// Append-only; the current version's row must equal kPulseRecordSize.
// Mirrored by PULSE_VERSION_SIZES in graftpulse.py (lint pass 3f).
[[maybe_unused]] constexpr int kPulseVersionSizes[][2] = {
    {1, 96},   // v1: through events_dropped
    {2, 104},  // v2: + graftprof on-CPU / GIL permille gauges
};

extern "C" {

// Hot-path emit: appends one record to the calling thread's ring and
// bumps the per-kind counter block (calls += 1, bytes += size,
// ns += dur_ns). t_ns == 0 means "stamp with scope_now_ns() here".
// No-op (one relaxed load) while the recorder is disabled.
void scope_emit(uint8_t kind, uint8_t op, uint16_t chan, uint32_t size,
                uint64_t seq_or_oid, uint64_t t_ns, uint64_t dur_ns);

// 1 while recording. Default comes from RAY_TPU_TORCH_GRAFTSCOPE (unset/1 =
// on, "0"/"false"/"off"/"no" = off), resolved once on first use.
int scope_enabled(void);
void scope_set_enabled(int on);

// CLOCK_MONOTONIC in ns — system-wide on Linux, so records from every
// process on a host share one clock domain.
uint64_t scope_now_ns(void);

// Drain every thread ring into buf as kScopeRecordSize-byte records.
// Returns bytes written (a multiple of the record size). Safe against
// concurrent writers and concurrent drainers (drain holds an internal
// mutex; writers never block).
int scope_drain(char* buf, int cap);

// Copy the cumulative counter block: out[3k..3k+2] = {calls, bytes, ns}
// for kind k. Writes min(max_kinds, kScopeKindCount) kinds; returns the
// number written.
int scope_counters(uint64_t* out, int max_kinds);

// Copy the cumulative log2 latency histograms: out[16k..16k+15] = the
// kScopeHistBuckets bucket counts for kind k. Writes
// min(max_kinds, kScopeKindCount) kinds; returns the number written.
int scope_histograms(uint64_t* out, int max_kinds);

// Records lost to ring wraparound or slot exhaustion since process
// start.
uint64_t scope_dropped(void);

}  // extern "C"

#endif  // RAY_TPU_SCOPE_CORE_H_
