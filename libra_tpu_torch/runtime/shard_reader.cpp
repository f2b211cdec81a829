// Native tar-shard sample reader with background readahead.
//
// The data-plane equivalent of the reference's webdataset C-accelerated IO
// (the reference leans on torch DataLoader worker processes; here a C++
// reader thread streams tar shards, groups members into samples, maintains
// a shuffle reservoir, and hands (key, jpg-bytes, json-bytes) tuples to
// Python through a bounded queue -- Python only does image decode and
// tokenization).
//
// C ABI (ctypes):
//   void*  lsr_open(const char** shards, int n_shards, unsigned long seed,
//                   int shuffle_buf, int queue_depth, int resample);
//   int    lsr_next(void* h, LsrSample* out);   // 0 ok, 1 end, <0 error
//   void   lsr_free_sample(LsrSample* s);
//   void   lsr_close(void* h);
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libshard_reader.so shard_reader.cpp -lpthread
// (libra_tpu_torch.runtime.build_library runs it at first use, into the
// package's build/ directory)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Sample {
  std::string key;
  std::vector<uint8_t> jpg;
  std::vector<uint8_t> json;
};

struct TarHeader {
  char name[100];
  char mode[8];
  char uid[8];
  char gid[8];
  char size[12];
  char mtime[12];
  char chksum[8];
  char typeflag;
  char linkname[100];
  char magic[6];
  char version[2];
  char uname[32];
  char gname[32];
  char devmajor[8];
  char devminor[8];
  char prefix[155];
  char pad[12];
};
static_assert(sizeof(TarHeader) == 512, "tar header must be 512 bytes");

uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; i++) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

bool ends_with(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

class ShardReader {
 public:
  ShardReader(std::vector<std::string> shards, uint64_t seed, int shuffle_buf,
              int queue_depth, bool resample)
      : shards_(std::move(shards)),
        rng_(seed),
        shuffle_buf_(shuffle_buf),
        queue_depth_(queue_depth),
        resample_(resample),
        done_(false),
        stop_(false) {
    worker_ = std::thread([this] { Run(); });
  }

  ~ShardReader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_pop_.notify_all();
    cv_push_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  // Returns nullptr at end of stream.
  Sample* Next() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [this] { return !queue_.empty() || done_ || stop_; });
    if (queue_.empty()) return nullptr;
    Sample* s = new Sample(std::move(queue_.front()));
    queue_.pop_front();
    cv_push_.notify_one();
    return s;
  }

 private:
  void Emit(Sample&& s) {
    // shuffle reservoir: fill, then swap a random slot out
    if ((int)reservoir_.size() < shuffle_buf_) {
      reservoir_.push_back(std::move(s));
      return;
    }
    std::uniform_int_distribution<size_t> d(0, reservoir_.size() - 1);
    size_t idx = d(rng_);
    std::swap(reservoir_[idx], s);
    Push(std::move(s));
  }

  void Push(Sample&& s) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [this] {
      return (int)queue_.size() < queue_depth_ || stop_;
    });
    if (stop_) return;
    queue_.push_back(std::move(s));
    cv_pop_.notify_one();
  }

  // Read-based skip: pipe (popen) streams are not seekable, and tar pad
  // skips are tiny (<512B) so read-to-skip costs nothing on files either.
  static bool SkipBytes(FILE* f, uint64_t n) {
    char scratch[4096];
    while (n > 0) {
      size_t chunk = n < sizeof(scratch) ? (size_t)n : sizeof(scratch);
      size_t got = fread(scratch, 1, chunk, f);
      if (got == 0) return false;
      n -= got;
    }
    return true;
  }

  void ReadShard(const std::string& path) {
    // remote sources: "pipe:<shell command>" streams a subprocess's stdout
    // (the reference's webdataset gopen pipe semantics; skip-and-continue
    // on stream errors like every other stage)
    const bool piped = path.rfind("pipe:", 0) == 0;
    FILE* f = piped ? popen(path.c_str() + 5, "r") : fopen(path.c_str(), "rb");
    if (!f) {
      fprintf(stderr, "[shard_reader] cannot open %s -- skipping\n",
              path.c_str());
      return;
    }
    Sample current;
    TarHeader hdr;
    std::vector<uint8_t> buf;
    while (!stop_ && fread(&hdr, 1, 512, f) == 512) {
      if (hdr.name[0] == '\0') break;  // end-of-archive blocks
      uint64_t size = parse_octal(hdr.size, sizeof(hdr.size));
      std::string name(hdr.name, strnlen(hdr.name, sizeof(hdr.name)));
      uint64_t padded = (size + 511) & ~uint64_t(511);
      bool is_file = hdr.typeflag == '0' || hdr.typeflag == '\0';
      auto dot = name.rfind('.');
      if (!is_file || dot == std::string::npos) {
        if (!SkipBytes(f, padded)) break;
        continue;
      }
      std::string key = name.substr(0, dot);
      std::string ext = name.substr(dot + 1);
      buf.resize(size);
      if (fread(buf.data(), 1, size, f) != size) break;
      if (padded > size && !SkipBytes(f, padded - size)) break;

      if (!current.key.empty() && current.key != key) {
        if (!current.jpg.empty() || !current.json.empty())
          Emit(std::move(current));
        current = Sample();
      }
      current.key = key;
      if (ext == "jpg" || ext == "jpeg" || ext == "png" || ext == "webp") {
        current.jpg = buf;
      } else if (ext == "json") {
        current.json = buf;
      }
    }
    if (!current.key.empty() &&
        (!current.jpg.empty() || !current.json.empty()))
      Emit(std::move(current));
    if (piped) pclose(f); else fclose(f);
  }

  void Run() {
    if (resample_) {
      std::uniform_int_distribution<size_t> d(0, shards_.size() - 1);
      while (!stop_) ReadShard(shards_[d(rng_)]);
    } else {
      std::vector<size_t> order(shards_.size());
      for (size_t i = 0; i < order.size(); i++) order[i] = i;
      std::shuffle(order.begin(), order.end(), rng_);
      for (size_t i : order) {
        if (stop_) break;
        ReadShard(shards_[i]);
      }
      // drain the reservoir
      std::shuffle(reservoir_.begin(), reservoir_.end(), rng_);
      for (auto& s : reservoir_) {
        if (stop_) break;
        Push(std::move(s));
      }
      reservoir_.clear();
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_pop_.notify_all();
  }

  std::vector<std::string> shards_;
  std::mt19937_64 rng_;
  int shuffle_buf_;
  int queue_depth_;
  bool resample_;

  std::vector<Sample> reservoir_;
  std::deque<Sample> queue_;
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::atomic<bool> done_, stop_;
  std::thread worker_;
};

}  // namespace

extern "C" {

struct LsrSample {
  char* key;
  uint8_t* jpg;
  uint64_t jpg_len;
  uint8_t* json;
  uint64_t json_len;
  void* owner;  // Sample*, freed by lsr_free_sample
};

void* lsr_open(const char** shards, int n_shards, unsigned long seed,
               int shuffle_buf, int queue_depth, int resample) {
  std::vector<std::string> v;
  v.reserve(n_shards);
  for (int i = 0; i < n_shards; i++) v.emplace_back(shards[i]);
  if (v.empty()) return nullptr;
  return new ShardReader(std::move(v), seed, shuffle_buf, queue_depth,
                         resample != 0);
}

int lsr_next(void* h, LsrSample* out) {
  auto* r = static_cast<ShardReader*>(h);
  Sample* s = r->Next();
  if (!s) return 1;
  out->key = const_cast<char*>(s->key.c_str());
  out->jpg = s->jpg.data();
  out->jpg_len = s->jpg.size();
  out->json = s->json.data();
  out->json_len = s->json.size();
  out->owner = s;
  return 0;
}

void lsr_free_sample(LsrSample* s) {
  delete static_cast<Sample*>(s->owner);
  s->owner = nullptr;
}

void lsr_close(void* h) { delete static_cast<ShardReader*>(h); }

}  // extern "C"
