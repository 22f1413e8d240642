// Native unit tests for the graftcopy engine (copy_core.cc): scatter
// correctness (gaps, ordering, partial chunks), pool parallelism,
// concurrent scatters through one shared engine (the TSAN target —
// workers and callers hand jobs around under the engine mutex), error
// propagation, and the O_TMPFILE+linkat helper. Same plain-assert
// harness as object_store_test.cc; runs under `make test` and the
// TSAN/ASAN targets.

#undef NDEBUG
#include <cassert>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {
typedef struct {
  const void* src;
  uint64_t len;
  uint64_t off;
} CopySeg;
void* copy_engine_create(int nthreads);
void copy_engine_destroy(void* handle);
int copy_engine_threads(void* handle);
int copy_write_scatter(void* handle, int fd, const CopySeg* segs,
                       int nsegs);
int copy_linkat(int src_fd, const char* dst);
}

namespace {

// The suites' scratch files go under $TMPDIR (else /tmp).
std::string TmpBase() {
  const char* t = std::getenv("TMPDIR");
  return (t != nullptr && *t != '\0') ? std::string(t) : std::string("/tmp");
}

std::string TempDir(const char* name) {
  std::string dir = TmpBase() + "/raytpu_torch_copy_test_" + name + "_" +
                    std::to_string(::getpid());
  std::string cmd = "rm -rf " + dir + " && mkdir -p " + dir;
  assert(std::system(cmd.c_str()) == 0);
  return dir;
}

std::vector<char> ReadAll(int fd) {
  off_t sz = ::lseek(fd, 0, SEEK_END);
  assert(sz >= 0);
  std::vector<char> out((size_t)sz);
  assert(::pread(fd, out.data(), out.size(), 0) == (ssize_t)out.size());
  return out;
}

void CheckScatter(void* eng, size_t nsegs, size_t seg_len, size_t gap) {
  std::string dir = TempDir("scatter");
  std::string path = dir + "/out";
  int fd = ::open(path.c_str(), O_CREAT | O_RDWR | O_TRUNC, 0600);
  assert(fd >= 0);
  std::vector<std::vector<char>> bufs(nsegs);
  std::vector<CopySeg> segs(nsegs);
  uint64_t off = 0;
  for (size_t i = 0; i < nsegs; i++) {
    bufs[i].assign(seg_len + i, (char)('a' + (i % 26)));
    segs[i] = CopySeg{bufs[i].data(), bufs[i].size(), off};
    off += bufs[i].size() + gap;
  }
  assert(copy_write_scatter(eng, fd, segs.data(), (int)nsegs) == 0);
  std::vector<char> got = ReadAll(fd);
  assert(got.size() == segs.back().off + bufs.back().size());
  for (size_t i = 0; i < nsegs; i++) {
    assert(std::memcmp(got.data() + segs[i].off, bufs[i].data(),
                       bufs[i].size()) == 0);
    if (i + 1 < nsegs) {  // gap bytes read back as zeros (file holes)
      for (uint64_t g = segs[i].off + bufs[i].size();
           g < segs[i + 1].off; g++) {
        assert(got[g] == 0);
      }
    }
  }
  ::close(fd);
  assert(std::system(("rm -rf " + dir).c_str()) == 0);
}

void TestSequentialScatter() {
  // nthreads <= 0 auto-sizes the pool to min(16, cores - 1) workers
  // (copy_engine_create): -1 and 0 give the same pool, empty only on a
  // 1-core host, where every scatter runs on the calling thread.
  unsigned hw = std::thread::hardware_concurrency();
  int want = hw > 1 ? (int)hw - 1 : 0;
  if (want > 16) want = 16;
  void* eng = copy_engine_create(-1);
  void* eng0 = copy_engine_create(0);
  assert(copy_engine_threads(eng) == want);
  assert(copy_engine_threads(eng0) == want);
  CheckScatter(eng, 5, 1000, 37);
  CheckScatter(eng0, 5, 1000, 37);
  copy_engine_destroy(eng);
  copy_engine_destroy(eng0);
  std::printf("  sequential scatter OK (hardware_concurrency %u, "
              "auto-sized pool %d)\n", hw, want);
}

void TestPooledScatter() {
  void* eng = copy_engine_create(4);
  assert(copy_engine_threads(eng) == 4);
  // > one chunk (8 MiB) total so the pool actually engages; odd sizes
  // exercise the chunk-split remainders.
  CheckScatter(eng, 3, (9 << 20) + 123, 61);
  CheckScatter(eng, 1, (32 << 20) + 1, 0);
  copy_engine_destroy(eng);
  std::printf("  pooled scatter OK\n");
}

void TestConcurrentScatters() {
  // Many caller threads share one engine: jobs queue behind each other
  // and every caller must get exactly its own bytes back.
  void* eng = copy_engine_create(3);
  std::string dir = TempDir("concurrent");
  auto worker = [&](int t) {
    std::string path = dir + "/out" + std::to_string(t);
    int fd = ::open(path.c_str(), O_CREAT | O_RDWR | O_TRUNC, 0600);
    assert(fd >= 0);
    std::vector<char> buf((10 << 20) + t, (char)('A' + t));
    for (int rep = 0; rep < 3; rep++) {
      CopySeg seg{buf.data(), buf.size(), 0};
      assert(copy_write_scatter(eng, fd, &seg, 1) == 0);
    }
    std::vector<char> got = ReadAll(fd);
    assert(got.size() == buf.size());
    assert(std::memcmp(got.data(), buf.data(), buf.size()) == 0);
    ::close(fd);
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < 4; t++) ts.emplace_back(worker, t);
  for (auto& th : ts) th.join();
  copy_engine_destroy(eng);
  assert(std::system(("rm -rf " + dir).c_str()) == 0);
  std::printf("  concurrent scatters OK\n");
}

void TestErrorPropagation() {
  void* eng = copy_engine_create(2);
  std::vector<char> buf(20 << 20, 'x');
  CopySeg seg{buf.data(), buf.size(), 0};
  // Closed fd: every chunk fails; the first errno comes back negated.
  assert(copy_write_scatter(eng, /*fd=*/-1, &seg, 1) == -EBADF);
  // Read-only fd fails too (engine path, multiple chunks).
  int fd = ::open("/dev/null", O_RDONLY);
  assert(fd >= 0);
  assert(copy_write_scatter(eng, fd, &seg, 1) == -EBADF);
  ::close(fd);
  // Empty scatter is a no-op.
  assert(copy_write_scatter(eng, -1, nullptr, 0) == 0);
  copy_engine_destroy(eng);
  std::printf("  error propagation OK\n");
}

void TestLinkat() {
  std::string dir = TempDir("linkat");
  std::string dst = dir + "/linked";
  int fd = ::open(dir.c_str(), O_TMPFILE | O_RDWR, 0600);
  if (fd < 0) {
    // Filesystem without O_TMPFILE: exercise the named-source fallback
    // shape instead (linkat on a regular file is EEXIST-checked too).
    std::string src = dir + "/src";
    fd = ::open(src.c_str(), O_CREAT | O_RDWR, 0600);
    assert(fd >= 0);
  }
  assert(::write(fd, "graftcopy", 9) == 9);
  struct stat st;
  assert(::stat(dst.c_str(), &st) != 0);  // not visible yet
  assert(copy_linkat(fd, dst.c_str()) == 0);
  assert(::stat(dst.c_str(), &st) == 0 && st.st_size == 9);
  char got[16] = {0};
  int rfd = ::open(dst.c_str(), O_RDONLY);
  assert(::read(rfd, got, 9) == 9 && std::memcmp(got, "graftcopy", 9) == 0);
  ::close(rfd);
  // Linking over an existing name must fail cleanly with -EEXIST (the
  // put path maps this to "object already stored").
  assert(copy_linkat(fd, dst.c_str()) == -EEXIST);
  ::close(fd);
  assert(std::system(("rm -rf " + dir).c_str()) == 0);
  std::printf("  linkat OK\n");
}

}  // namespace

int main() {
  TestSequentialScatter();
  TestPooledScatter();
  TestConcurrentScatters();
  TestErrorPropagation();
  TestLinkat();
  std::printf("copy_core_test: ALL OK\n");
  return 0;
}
