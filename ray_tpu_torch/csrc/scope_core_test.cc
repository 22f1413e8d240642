// Unit tests for the graftscope recorder (scope_core.cc). Run plain and
// under TSAN/ASAN in CI — the drain-while-writing test is the one the
// sanitizers care about: a torn read that escapes the lap check is a
// data race TSAN flags and a correctness bug this test flags.

#include "scope_core.h"

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,     \
                   #cond);                                             \
      std::abort();                                                    \
    }                                                                  \
  } while (0)

namespace {

struct Rec {
  uint8_t kind, op;
  uint16_t chan;
  uint32_t size;
  uint64_t seq_or_oid, t_ns;
};

std::vector<Rec> Drain() {
  std::vector<Rec> out;
  std::vector<char> buf(1 << 20);
  for (;;) {
    int n = scope_drain(buf.data(), (int)buf.size());
    CHECK(n >= 0);
    CHECK(n % kScopeRecordSize == 0);
    for (int i = 0; i < n; i += kScopeRecordSize) {
      ScopeWireRec w;
      std::memcpy(&w, buf.data() + i, kScopeRecordSize);
      out.push_back(Rec{w.kind, w.op, w.chan, w.size, w.seq_or_oid,
                        w.t_ns});
    }
    if (n == 0) return out;
  }
}

int TestRoundtrip() {
  Drain();  // discard anything earlier tests left behind
  scope_emit(kScopeRpcSend, 1, 0x1234, 99, 77, 5, 0);
  scope_emit(kScopeScEnd, 6, 0, 1000, 0xdeadbeef, 42, 1000);
  auto recs = Drain();
  CHECK(recs.size() == 2);
  CHECK(recs[0].kind == kScopeRpcSend);
  CHECK(recs[0].op == 1);
  CHECK(recs[0].chan == 0x1234);
  CHECK(recs[0].size == 99);
  CHECK(recs[0].seq_or_oid == 77);
  CHECK(recs[0].t_ns == 5);
  CHECK(recs[1].kind == kScopeScEnd);
  CHECK(recs[1].seq_or_oid == 0xdeadbeef);
  // t_ns == 0 stamps "now" from the monotonic clock.
  uint64_t before = scope_now_ns();
  scope_emit(kScopeRpcWake, 0, 0, 0, 0, 0, 0);
  uint64_t after = scope_now_ns();
  recs = Drain();
  CHECK(recs.size() == 1);
  CHECK(recs[0].t_ns >= before && recs[0].t_ns <= after);
  return 0;
}

int TestWraparound() {
  Drain();
  uint64_t dropped0 = scope_dropped();
  // 3x any plausible ring capacity: the drain must return only the
  // freshest window, count the rest as dropped, and keep seqs ordered.
  const uint64_t kN = 3 * 4096;
  for (uint64_t i = 0; i < kN; i++) {
    scope_emit(kScopeRpcSend, 1, 0, 8, i, 1, 0);
  }
  auto recs = Drain();
  CHECK(!recs.empty());
  CHECK(recs.size() < kN);
  CHECK(scope_dropped() - dropped0 == kN - recs.size());
  // Survivors are the most recent, in order.
  for (size_t i = 0; i < recs.size(); i++) {
    CHECK(recs[i].seq_or_oid == kN - recs.size() + i);
  }
  return 0;
}

int TestDrainWhileWriting() {
  Drain();
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> written{0};
  const int kWriters = 4;
  std::vector<std::thread> writers;
  for (int w = 0; w < kWriters; w++) {
    writers.emplace_back([&stop, &written, w] {
      uint64_t seq = 0;
      while (!stop.load(std::memory_order_relaxed)) {
        // seq encodes (writer, ordinal) so the drainer can check
        // per-writer monotonicity through wraparound.
        scope_emit(kScopeRpcSend, (uint8_t)(w + 1), (uint16_t)w, 24,
                   ((uint64_t)w << 48) | seq++, 1, 0);
        written.fetch_add(1, std::memory_order_relaxed);
      }
    });
  }
  uint64_t last_seq[kWriters] = {0};
  bool seen[kWriters] = {false};
  uint64_t got = 0;
  std::vector<char> buf(1 << 20);
  while (written.load() < 400000) {
    // One bounded drain pass per iteration (Drain()'s run-until-empty
    // loop could chase the writers forever).
    int n = scope_drain(buf.data(), (int)buf.size());
    CHECK(n >= 0 && n % kScopeRecordSize == 0);
    std::vector<Rec> recs;
    for (int i = 0; i < n; i += kScopeRecordSize) {
      ScopeWireRec w;
      std::memcpy(&w, buf.data() + i, kScopeRecordSize);
      recs.push_back(
          Rec{w.kind, w.op, w.chan, w.size, w.seq_or_oid, w.t_ns});
    }
    for (const Rec& r : recs) {
      CHECK(r.kind == kScopeRpcSend);
      int w = (int)(r.seq_or_oid >> 48);
      CHECK(w >= 0 && w < kWriters);
      CHECK(r.op == (uint8_t)(w + 1));
      CHECK(r.chan == (uint16_t)w);
      CHECK(r.size == 24);
      uint64_t seq = r.seq_or_oid & 0xFFFFFFFFFFFFull;
      if (seen[w]) CHECK(seq > last_seq[w]);
      last_seq[w] = seq;
      seen[w] = true;
      got++;
    }
  }
  stop.store(true);
  for (auto& t : writers) t.join();
  // On a 1-core host every write may land between two of the loop's
  // passes — the rings still hold the freshest window, so the final
  // drain validates and counts too.
  for (const Rec& r : Drain()) {
    CHECK(r.kind == kScopeRpcSend);
    int w = (int)(r.seq_or_oid >> 48);
    CHECK(w >= 0 && w < kWriters);
    uint64_t seq = r.seq_or_oid & 0xFFFFFFFFFFFFull;
    if (seen[w]) CHECK(seq > last_seq[w]);
    last_seq[w] = seq;
    seen[w] = true;
    got++;
  }
  CHECK(got > 0);
  return 0;
}

int TestDisable() {
  Drain();
  uint64_t calls0[3 * kScopeKindCount];
  scope_counters(calls0, kScopeKindCount);
  scope_set_enabled(0);
  CHECK(scope_enabled() == 0);
  scope_emit(kScopeRpcSend, 1, 0, 8, 1, 1, 0);
  scope_emit(kScopeCopyLink, 0, 0, 0, 0, 0, 0);
  CHECK(Drain().empty());
  uint64_t calls1[3 * kScopeKindCount];
  scope_counters(calls1, kScopeKindCount);
  for (int i = 0; i < 3 * kScopeKindCount; i++) CHECK(calls0[i] == calls1[i]);
  scope_set_enabled(1);
  CHECK(scope_enabled() == 1);
  scope_emit(kScopeRpcSend, 1, 0, 8, 2, 1, 0);
  CHECK(Drain().size() == 1);
  return 0;
}

int TestCounters() {
  scope_set_enabled(1);
  uint64_t c0[3 * kScopeKindCount];
  CHECK(scope_counters(c0, kScopeKindCount) == kScopeKindCount);
  scope_emit(kScopeCopyScatter, 0, 0, 1000, 10, 20, 7);
  scope_emit(kScopeCopyScatter, 0, 0, 500, 30, 40, 3);
  uint64_t c1[3 * kScopeKindCount];
  scope_counters(c1, kScopeKindCount);
  int k = kScopeCopyScatter;
  CHECK(c1[k * 3 + 0] - c0[k * 3 + 0] == 2);     // calls
  CHECK(c1[k * 3 + 1] - c0[k * 3 + 1] == 1500);  // bytes
  CHECK(c1[k * 3 + 2] - c0[k * 3 + 2] == 10);    // ns
  Drain();
  return 0;
}

int TestHistograms() {
  scope_set_enabled(1);
  uint64_t h0[kScopeHistBuckets * kScopeKindCount];
  CHECK(scope_histograms(h0, kScopeKindCount) == kScopeKindCount);
  int k = kScopeScEnd;
  // dur_ns == 0 must not touch the histogram (no duration recorded).
  scope_emit((uint8_t)k, 0, 0, 8, 1, 1, 0);
  // Sub-microsecond and ~1.5us land in bucket 0; each doubling above
  // 2^(shift+1) moves one bucket; huge durations clamp into the last.
  scope_emit((uint8_t)k, 0, 0, 8, 2, 1, 100);
  scope_emit((uint8_t)k, 0, 0, 8, 3, 1, 1500);
  scope_emit((uint8_t)k, 0, 0, 8, 4, 1, 1ull << (kScopeHistShift + 3));
  scope_emit((uint8_t)k, 0, 0, 8, 5, 1, 1ull << 62);
  uint64_t h1[kScopeHistBuckets * kScopeKindCount];
  scope_histograms(h1, kScopeKindCount);
  uint64_t* a = h0 + k * kScopeHistBuckets;
  uint64_t* b = h1 + k * kScopeHistBuckets;
  CHECK(b[0] - a[0] == 2);
  CHECK(b[3] - a[3] == 1);
  CHECK(b[kScopeHistBuckets - 1] - a[kScopeHistBuckets - 1] == 1);
  uint64_t total = 0;
  for (int i = 0; i < kScopeHistBuckets; i++) total += b[i] - a[i];
  CHECK(total == 4);
  // Disabled recorder leaves the histograms untouched too.
  scope_set_enabled(0);
  scope_emit((uint8_t)k, 0, 0, 8, 6, 1, 1500);
  uint64_t h2[kScopeHistBuckets * kScopeKindCount];
  scope_histograms(h2, kScopeKindCount);
  for (int i = 0; i < kScopeHistBuckets * kScopeKindCount; i++) {
    CHECK(h1[i] == h2[i]);
  }
  scope_set_enabled(1);
  Drain();
  return 0;
}

}  // namespace

int main() {
  scope_set_enabled(1);
  int rc = 0;
  rc |= TestRoundtrip();
  std::printf("scope roundtrip ok\n");
  rc |= TestCounters();
  std::printf("scope counters ok\n");
  rc |= TestHistograms();
  std::printf("scope histograms ok\n");
  rc |= TestWraparound();
  std::printf("scope wraparound ok\n");
  rc |= TestDisable();
  std::printf("scope disable ok\n");
  rc |= TestDrainWhileWriting();
  std::printf("scope drain-while-writing ok\n");
  if (rc == 0) std::printf("scope_core_test: ALL OK\n");
  return rc;
}
