// Unit tests for the graftlog ring (log_core.cc). Run plain and under
// TSAN/ASAN in CI — the drain-while-writing storm exercises the
// single-writer ring against a concurrent reader (the same race the
// node agent's tailer runs live), and the file-decode test pins the
// crash-persistence contract: everything emitted is on the filesystem
// the moment log_emit returns, exactly as the salvage path will find
// it after a SIGKILL.

#include "log_core.h"

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>
#include <unistd.h>

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,     \
                   #cond);                                             \
      std::abort();                                                    \
    }                                                                  \
  } while (0)

namespace {

char g_dir[256];

std::string RingPath(uint64_t pid) {
  char buf[320];
  std::snprintf(buf, sizeof(buf), "%s/logring-%llu", g_dir,
                (unsigned long long)pid);
  return std::string(buf);
}

std::vector<LogWireRec> DrainOnce() {
  std::vector<LogWireRec> out;
  std::vector<char> buf(1 << 20);
  int n = log_drain(buf.data(), (int)buf.size());
  CHECK(n >= 0);
  CHECK(n % kLogRecordSize == 0);
  for (int i = 0; i < n; i += kLogRecordSize) {
    LogWireRec w;
    std::memcpy(&w, buf.data() + i, kLogRecordSize);
    out.push_back(w);
  }
  return out;
}

std::vector<LogWireRec> Drain() {
  std::vector<LogWireRec> out;
  for (;;) {
    auto recs = DrainOnce();
    if (recs.empty()) return out;
    out.insert(out.end(), recs.begin(), recs.end());
  }
}

std::string Field(const char* p, int cap) {
  int n = 0;
  while (n < cap && p[n] != '\0') n++;
  return std::string(p, (size_t)n);
}

int TestDisabled() {
  log_set_enabled(0);
  CHECK(log_enabled() == 0);
  CHECK(log_emit(20, kLogSrcLogger, "t", "a", "dropped", -1) == 0);
  log_set_enabled(1);
  CHECK(log_enabled() == 1);
  return 0;
}

int TestRoundtrip() {
  CHECK(log_ring_open(g_dir, (uint64_t)getpid()) == 0);
  CHECK(log_emitted() == 0);
  uint64_t s1 = log_emit(20, kLogSrcLogger,
                         "00112233445566778899aabbccddeeff",
                         "a1b2c3d4e5f6", "hello graftlog", -1);
  CHECK(s1 == 1);
  uint64_t s2 = log_emit(40, kLogSrcStderr, "", nullptr, "boom", 4);
  CHECK(s2 == 2);
  // Oversized line: msg truncates, line_len keeps the true length.
  std::string big(kLogMsgCap + 100, 'x');
  uint64_t s3 =
      log_emit(30, kLogSrcStdout, "ff", "ee", big.c_str(), (int)big.size());
  CHECK(s3 == 3);
  CHECK(log_emitted() == 3);
  auto recs = Drain();
  CHECK(recs.size() == 3);
  CHECK(recs[0].level == 20 && recs[0].source == kLogSrcLogger);
  CHECK(recs[0].seq == 1);
  CHECK(Field(recs[0].task, kLogTaskCap) ==
        "00112233445566778899aabbccddeeff");
  CHECK(Field(recs[0].actor, kLogActorCap) == "a1b2c3d4e5f6");
  CHECK(recs[0].line_len == 14);
  CHECK(Field(recs[0].msg, kLogMsgCap) == "hello graftlog");
  CHECK(recs[0].t_ns > 0);
  CHECK(recs[1].level == 40 && recs[1].source == kLogSrcStderr);
  CHECK(Field(recs[1].task, kLogTaskCap).empty());
  CHECK(Field(recs[1].actor, kLogActorCap).empty());
  CHECK(Field(recs[1].msg, kLogMsgCap) == "boom");
  CHECK(recs[2].line_len == (uint16_t)(kLogMsgCap + 100));
  CHECK(Field(recs[2].msg, kLogMsgCap) == std::string(kLogMsgCap, 'x'));
  CHECK(recs[1].t_ns >= recs[0].t_ns && recs[2].t_ns >= recs[1].t_ns);
  CHECK(Drain().empty());
  return 0;
}

int TestFileDecode() {
  // The crash-persistence contract: the moment log_emit returns, the
  // record is decodable from the FILE by another reader — no flush or
  // clean shutdown required. Decode the bytes exactly as the Python
  // salvage path does.
  uint64_t pid = (uint64_t)getpid();
  std::string path = RingPath(pid);
  FILE* f = std::fopen(path.c_str(), "rb");
  CHECK(f != nullptr);
  struct stat st;
  CHECK(stat(path.c_str(), &st) == 0);
  CHECK(st.st_size ==
        (off_t)kLogHeaderSize + (off_t)kLogRingSlots * kLogRecordSize);
  uint32_t u32[4];
  CHECK(std::fread(u32, sizeof(u32), 1, f) == 1);
  CHECK(u32[0] == (uint32_t)kLogMagic);
  CHECK(u32[1] == (uint32_t)kLogRingVersion);
  CHECK(u32[2] == (uint32_t)kLogRecordSize);
  CHECK(u32[3] == (uint32_t)kLogRingSlots);
  uint64_t u64[4];
  CHECK(std::fread(u64, sizeof(u64), 1, f) == 1);
  CHECK(u64[0] == pid);
  uint64_t head = u64[1];
  CHECK(head == log_emitted());
  CHECK(head >= 3);  // TestRoundtrip's records are already on disk
  // Slot (head - 1) holds the newest record.
  uint64_t last = head - 1;
  CHECK(std::fseek(f,
                   (long)(kLogHeaderSize +
                          (last % kLogRingSlots) * kLogRecordSize),
                   SEEK_SET) == 0);
  LogWireRec w;
  CHECK(std::fread(&w, sizeof(w), 1, f) == 1);
  CHECK(w.seq == (uint32_t)head);
  std::fclose(f);
  return 0;
}

int TestEmitBatch() {
  Drain();
  uint64_t base = log_emitted();
  // Mixed batch: empty lines (doubled \n, trailing \n) are skipped,
  // the rest land as consecutive records sharing one timestamp.
  uint64_t h = log_emit_batch(20, kLogSrcStdout, "feed", "beef",
                              "alpha\n\nbravo\ncharlie\n", 21);
  CHECK(h == base + 3);
  auto recs = Drain();
  CHECK(recs.size() == 3);
  CHECK(Field(recs[0].msg, kLogMsgCap) == "alpha");
  CHECK(Field(recs[1].msg, kLogMsgCap) == "bravo");
  CHECK(Field(recs[2].msg, kLogMsgCap) == "charlie");
  CHECK(recs[0].t_ns == recs[2].t_ns);
  CHECK(recs[0].seq == (uint32_t)(base + 1));
  CHECK(recs[2].seq == (uint32_t)(base + 3));
  for (const LogWireRec& r : recs) {
    CHECK(r.level == 20 && r.source == kLogSrcStdout);
    CHECK(Field(r.task, kLogTaskCap) == "feed");
    CHECK(Field(r.actor, kLogActorCap) == "beef");
  }
  // No final newline: the tail still counts as a line.
  CHECK(log_emit_batch(20, kLogSrcStdout, "", "", "tail", 4) ==
        base + 4);
  CHECK(Drain().size() == 1);
  // All-empty batch appends nothing.
  CHECK(log_emit_batch(20, kLogSrcStdout, "", "", "\n\n", 2) == 0);
  CHECK(log_emitted() == base + 4);
  return 0;
}

int TestWraparound() {
  Drain();
  uint64_t dropped0 = log_dropped();
  uint64_t base = log_emitted();
  // Storm well past ring capacity without draining: the reader must
  // land in the fresh window and account the lapped slots as dropped.
  int total = 2 * kLogRingSlots + 37;
  for (int i = 0; i < total; i++) {
    char line[64];
    std::snprintf(line, sizeof(line), "line %d", i);
    CHECK(log_emit(20, kLogSrcStdout, "t", "a", line, -1) ==
          base + (uint64_t)i + 1);
  }
  auto recs = Drain();
  CHECK(log_dropped() - dropped0 >= (uint64_t)(total - kLogRingSlots));
  CHECK(!recs.empty());
  CHECK((int)recs.size() <= kLogRingSlots);
  // Only records from the fresh window survive, in order, ending at
  // the newest.
  uint32_t prev = 0;
  for (const LogWireRec& r : recs) {
    CHECK(r.seq > prev);
    prev = r.seq;
  }
  CHECK(prev == (uint32_t)(base + (uint64_t)total));
  return 0;
}

int TestDrainWhileWriting() {
  Drain();
  // Writer threads storm the ring while the main thread drains — the
  // same shape as the node agent tailing a live worker. Every record
  // that survives the lap check must be well-formed.
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> wrote{0};
  std::vector<std::thread> writers;
  for (int w = 0; w < 3; w++) {
    writers.emplace_back([&, w] {
      int i = 0;
      while (!stop.load(std::memory_order_relaxed)) {
        char line[96];
        std::snprintf(line, sizeof(line), "writer %d line %d", w, i++);
        if (log_emit(20 + 10 * (w % 3), kLogSrcLogger,
                     "00112233445566778899aabbccddeeff", "a1b2c3d4e5f6",
                     line, -1) != 0) {
          wrote.fetch_add(1, std::memory_order_relaxed);
        }
      }
    });
  }
  uint64_t seen = 0;
  timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (;;) {
    for (const LogWireRec& r : DrainOnce()) {
      CHECK(r.level >= 20 && r.level <= 40);
      CHECK(r.source < kLogSrcCount);
      CHECK(r.seq != 0);
      CHECK(Field(r.task, kLogTaskCap) ==
            "00112233445566778899aabbccddeeff");
      CHECK(std::strncmp(r.msg, "writer ", 7) == 0);
      seen++;
    }
    timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if ((now.tv_sec - t0.tv_sec) * 1000000000L +
            (now.tv_nsec - t0.tv_nsec) >
        500L * 1000 * 1000) {
      break;
    }
  }
  stop.store(true);
  for (auto& t : writers) t.join();
  Drain();
  CHECK(seen > 0);
  CHECK(wrote.load(std::memory_order_relaxed) >= seen);
  return 0;
}

int TestReopen() {
  // Re-open resets the ring (fresh head) and re-points the writer.
  uint64_t pid = (uint64_t)getpid();
  CHECK(log_ring_open(g_dir, pid) == 0);
  CHECK(log_emitted() == 0);
  CHECK(log_emit(20, kLogSrcAgent, "", "", "after reopen", -1) == 1);
  auto recs = Drain();
  CHECK(recs.size() == 1);
  CHECK(Field(recs[0].msg, kLogMsgCap) == "after reopen");
  // Close unmaps but leaves the file for salvage; emit then drops.
  log_ring_close();
  uint64_t d0 = log_dropped();
  CHECK(log_emit(20, kLogSrcAgent, "", "", "into the void", -1) == 0);
  CHECK(log_dropped() == d0 + 1);
  struct stat st;
  CHECK(stat(RingPath(pid).c_str(), &st) == 0);
  return 0;
}

}  // namespace

int main() {
  const char* tmp = std::getenv("TMPDIR");
  std::snprintf(g_dir, sizeof(g_dir), "%s/graftlog_test_XXXXXX",
                (tmp != nullptr && *tmp != '\0') ? tmp : "/tmp");
  CHECK(mkdtemp(g_dir) != nullptr);
  log_set_enabled(1);
  int rc = 0;
  rc |= TestDisabled();
  std::printf("log disabled ok\n");
  rc |= TestRoundtrip();
  std::printf("log roundtrip ok\n");
  rc |= TestFileDecode();
  std::printf("log file decode ok\n");
  rc |= TestEmitBatch();
  std::printf("log emit batch ok\n");
  rc |= TestWraparound();
  std::printf("log wraparound ok\n");
  rc |= TestDrainWhileWriting();
  std::printf("log drain-while-writing ok\n");
  rc |= TestReopen();
  std::printf("log reopen ok\n");
  std::string cmd = std::string("rm -rf ") + g_dir;
  if (std::system(cmd.c_str()) != 0) return 1;
  if (rc == 0) std::printf("log_core_test: ALL OK\n");
  return rc;
}
