// graftlog: crash-persistent structured log ring for worker processes.
//
// Shared contract between the emit path (log_core.cc) and the Python
// seam (ray_tpu_torch/core/_native/graftlog.py). The wire record layout, the
// source table and the ring geometry below are lint-checked against the
// Python constants (tools/lint/wire_schema.py pass 3h) — keep both
// sides in sync.
//
// Unlike the graftscope/graftprof rings (anonymous process memory,
// gone with the process), the log ring is a MAP_SHARED file
// `logring-<pid>` in the node's tmpfs store directory. A SIGKILL'd or
// OOM-killed worker leaves its last kLogRingSlots records on the
// filesystem; the node agent salvages the tail post-mortem and attaches
// it to the task's grafttrail attempt record — no ptrace, no core dump.
//
// Layout: one 64-byte header page followed by kLogRingSlots fixed-width
// slots. Single writer (the owning process), lock-free: records are
// written into slot (head % slots), then the header's head counter is
// published with a release store. Readers (the agent tailing live, or
// salvage after death) re-read head after copying and discard anything
// the writer may have lapped — same discipline as the scope_core drain.
//
// Wire record (little-endian, fixed width, 256 bytes):
//   u8 level | u8 source | u16 line_len | u32 seq | u64 t_ns
//   | char task[32] | char actor[12] | char msg[196]
// level is the Python logging level (10..50); t_ns is CLOCK_REALTIME
// (wall) so records merge across nodes; task/actor carry the emitting
// thread's graftprof task context (NUL-padded hex); msg holds the first
// kLogMsgCap bytes of the line, line_len the un-truncated length.

#ifndef RAY_TPU_LOG_CORE_H_
#define RAY_TPU_LOG_CORE_H_

#include <cstdint>

#pragma pack(push, 1)
struct LogWireRec {  // 256 bytes on the wire, little-endian
  uint8_t level;
  uint8_t source;
  uint16_t line_len;
  uint32_t seq;
  uint64_t t_ns;
  char task[32];
  char actor[12];
  char msg[196];
};
#pragma pack(pop)

constexpr int kLogRecordSize = 256;
static_assert(sizeof(LogWireRec) == kLogRecordSize, "record packing");

// Record sources. Mirrored by LOG_SRC_* in graftlog.py (lint pass 3h).
[[maybe_unused]] constexpr uint8_t kLogSrcLogger = 0, kLogSrcStdout = 1,
                                   kLogSrcStderr = 2, kLogSrcAgent = 3;
[[maybe_unused]] constexpr int kLogSrcCount = 4;

// Ring geometry. Mirrored by LOG_* in graftlog.py (pass 3h). The file
// is kLogHeaderSize + kLogRingSlots * kLogRecordSize bytes (~1 MiB).
[[maybe_unused]] constexpr int kLogRingSlots = 4096;  // power of two
[[maybe_unused]] constexpr int kLogHeaderSize = 64;
[[maybe_unused]] constexpr int kLogTaskCap = 32;   // full TaskID hex
[[maybe_unused]] constexpr int kLogActorCap = 12;  // ActorID hex prefix
[[maybe_unused]] constexpr int kLogMsgCap = 196;
[[maybe_unused]] constexpr int kLogMagic = 0x474C4F31;     // "GLO1"
[[maybe_unused]] constexpr int kLogRingVersion = 1;

// File header (offsets fixed by the Python decoder):
//   u32 magic | u32 version | u32 record_size | u32 slots
//   | u64 pid | u64 head | u64 dropped | u64 start_ns | pad to 64
// head counts records ever emitted (monotonic, never wraps); dropped
// counts emit-side losses (emit before open / oversized bursts).

extern "C" {

// Create (or truncate) and map `<dir>/logring-<pid>` for this process.
// One ring per process; a second call re-points the writer at the new
// file. Returns 0, or -1 on open/map failure (emit then no-ops).
int log_ring_open(const char* dir, uint64_t pid);

// Unmap the ring (the FILE stays — salvage reads it after death).
void log_ring_close(void);

// Append one record. task/actor are NUL-terminated hex strings (may be
// "" / null); msg_len < 0 means strlen(msg). Truncates msg to
// kLogMsgCap (line_len keeps the true length). Returns the record's
// seq (>= 1), or 0 when disabled or the ring is not open.
uint64_t log_emit(int level, int source, const char* task,
                  const char* actor, const char* msg, int msg_len);

// Append a '\n'-separated batch of lines as consecutive records under
// one lock acquisition, one wall-clock read and one head publish —
// the stdio tee flushes its per-quantum line buffer through this
// instead of paying an FFI call per printed line. All records share
// level/source/task/actor; empty lines are skipped. Returns the seq
// of the last record appended, or 0 when disabled / not open / the
// batch held no non-empty lines.
uint64_t log_emit_batch(int level, int source, const char* task,
                        const char* actor, const char* lines, int len);

// 1 while emitting. Default comes from RAY_TPU_TORCH_GRAFTLOG (unset/1 = on,
// "0"/"false"/"off"/"no" = off), resolved once on first use.
int log_enabled(void);
void log_set_enabled(int on);

// Drain THIS process's ring from an internal cursor into buf as
// kLogRecordSize-byte records. Returns bytes written (a multiple of
// the record size). Safe against the concurrent writer: lapped slots
// are discarded into log_dropped(). Cross-process tailing and salvage
// decode the file directly in Python — same lap discipline.
int log_drain(char* buf, int cap);

// Records emitted since the ring opened (the header's head counter).
uint64_t log_emitted(void);

// Records lost: emit-side (ring not open while enabled) plus
// drain-side laps.
uint64_t log_dropped(void);

}  // extern "C"

#endif  // RAY_TPU_LOG_CORE_H_
