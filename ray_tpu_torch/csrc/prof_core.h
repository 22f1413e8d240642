// graftprof: always-on continuous profiler for worker processes.
//
// Shared contract between the sampler (prof_core.cc), the native planes
// that register their sidecar threads (rpc_core.cc, store_server.cc,
// copy_core.cc, object_store.cc) and the Python seam
// (ray_tpu_torch/core/_native/graftprof.py). The wire record layout, the kind
// table and the ring geometry below are lint-checked against the Python
// constants (tools/lint/wire_schema.py pass 3g) — keep both sides in
// sync.
//
// One native sampler thread ticks at kProfDefaultHz (67 Hz — an
// off-round rate so the tick train can't alias against the 2 s flush
// or the 1 s pulse). Each tick it:
//   * snapshots every registered thread's CLOCK_THREAD_CPUTIME_ID and
//     emits the delta since the previous tick (kProfThreadCpu);
//   * times one GIL acquire from outside the interpreter
//     (kProfGilWait) when the seam handed over PyGILState_Ensure /
//     PyGILState_Release pointers;
//   * stamps a kProfTick marker carrying the measured tick period.
// Records land in a graftscope-style lock-free fixed-record ring the
// Python seam drains on the worker flush tick.
//
// Wire record (little-endian, fixed width):
//   u8 kind | u8 slot | u16 flags | u32 val_us | u64 tick | u64 t_ns
// val_us is kind-specific: cpu-time delta (ThreadCpu), GIL acquire
// latency (GilWait), or the measured tick period (Tick), all in µs.

#ifndef RAY_TPU_PROF_CORE_H_
#define RAY_TPU_PROF_CORE_H_

#include <cstdint>

#pragma pack(push, 1)
struct ProfWireRec {  // 24 bytes on the wire, little-endian
  uint8_t kind;
  uint8_t slot;
  uint16_t flags;
  uint32_t val_us;
  uint64_t tick;
  uint64_t t_ns;
};
#pragma pack(pop)

constexpr int kProfRecordSize = 24;
static_assert(sizeof(ProfWireRec) == kProfRecordSize, "record packing");

// Record kinds. Mirrored by PROF_* in graftprof.py (lint pass 3g).
[[maybe_unused]] constexpr uint8_t kProfTick = 1, kProfThreadCpu = 2,
                                   kProfGilWait = 3;
[[maybe_unused]] constexpr int kProfKindCount = 4;  // 1 + highest kind

// Sampler geometry. Mirrored by PROF_* in graftprof.py (pass 3g).
[[maybe_unused]] constexpr int kProfDefaultHz = 67;
[[maybe_unused]] constexpr int kProfMaxThreads = 64;
[[maybe_unused]] constexpr int kProfRingCap = 4096;  // power of two
[[maybe_unused]] constexpr int kProfNameCap = 32;    // incl. NUL

extern "C" {

// Register the CALLING thread for per-tick CPU-time sampling. Returns
// the slot index (echoed in kProfThreadCpu records), or -1 when the
// table is full or the thread's CPU clock is unavailable. Idempotent
// per thread (the lease is thread_local); slots recycle on thread
// exit.
int prof_register_thread(const char* name);

// Hand over PyGILState_Ensure / PyGILState_Release so the sampler can
// time GIL acquisition from outside the interpreter. Both null
// disables the probe (the C test injects stand-ins here).
void prof_set_gil_fns(void* ensure_fn, void* release_fn);

// Start the sampler thread at `hz` ticks/s (<= 0 = kProfDefaultHz).
// Idempotent; returns 0 when the thread is running. prof_stop() joins
// it — the Python seam calls this from atexit so no GIL probe can run
// during interpreter finalization.
int prof_start(int hz);
void prof_stop(void);

// 1 while sampling. Default comes from RAY_TPU_TORCH_GRAFTPROF (unset/1 =
// on, "0"/"false"/"off"/"no" = off), resolved once on first use.
// While disabled the sampler thread idles: no clock reads, no GIL
// probes, no records.
int prof_enabled(void);
void prof_set_enabled(int on);

// Drain the sample ring into buf as kProfRecordSize-byte records.
// Returns bytes written (a multiple of the record size). Safe against
// the concurrent sampler writer and concurrent drainers.
int prof_drain(char* buf, int cap);

// Records lost to ring wraparound since process start.
uint64_t prof_dropped(void);

// Sampler ticks since process start.
uint64_t prof_ticks(void);

// Registered-thread table: slots ever handed out (dead slots stay in
// range until recycled).
int prof_thread_count(void);

// Copy per-slot cumulative thread CPU ns: out[s] = total CPU time the
// sampler has observed for slot s. Writes min(max_slots, table size)
// entries; returns the number written. Dead threads keep their last
// total (attribution for exited sidecar threads stays visible).
int prof_thread_cpu_ns(uint64_t* out, int max_slots);

// Copy slot s's registered name into buf (NUL-terminated, truncated to
// kProfNameCap). Returns the name length, or -1 for an unused slot.
int prof_thread_name(int slot, char* buf, int cap);

// Cumulative GIL probe totals since process start.
uint64_t prof_gil_wait_ns(void);
uint64_t prof_gil_probes(void);

}  // extern "C"

#endif  // RAY_TPU_PROF_CORE_H_
