// stgx_torch native data loader: .npy parsing + background prefetch thread
// pool, a copy of the JAX package's stgx/native/npy_loader.cpp.
//
// The runtime counterpart of the reference's torch DataLoader workers
// (its only in-process native machinery besides the CUDA shift op): trials
// are decoded off the critical path so the accelerator never waits on file
// IO. Exposed through a C ABI consumed via ctypes
// (stgx_torch/native/__init__.py), built with g++ at first use.
//
// Supports .npy format v1.0/v2.0, little-endian '<f4'/'<f8'/'<i4'/'<i8',
// C-contiguous arrays, converted to float32 on read.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::vector<long> shape;
  std::vector<float> data;
  bool ok = false;
};

bool parse_header(std::ifstream& f, std::string& descr, bool& fortran,
                  std::vector<long>& shape) {
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  unsigned char ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    uint16_t h16;
    f.read(reinterpret_cast<char*>(&h16), 2);
    hlen = h16;
  } else {
    f.read(reinterpret_cast<char*>(&hlen), 4);
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);

  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    return header.substr(p + 1);
  };

  std::string d = find_val("descr");
  size_t q1 = d.find('\'');
  size_t q2 = d.find('\'', q1 + 1);
  descr = d.substr(q1 + 1, q2 - q1 - 1);

  fortran = find_val("fortran_order").find("True") != std::string::npos;

  std::string s = find_val("shape");
  size_t lp = s.find('(');
  size_t rp = s.find(')');
  std::string tuple = s.substr(lp + 1, rp - lp - 1);
  shape.clear();
  long cur = -1;
  for (char c : tuple) {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) shape.push_back(cur);
  return true;
}

template <typename T>
void convert(std::ifstream& f, std::vector<float>& out, size_t n) {
  std::vector<T> buf(n);
  f.read(reinterpret_cast<char*>(buf.data()), n * sizeof(T));
  out.resize(n);
  for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(buf[i]);
}

NpyArray load_npy(const std::string& path) {
  NpyArray arr;
  std::ifstream f(path, std::ios::binary);
  if (!f) return arr;
  std::string descr;
  bool fortran = false;
  if (!parse_header(f, descr, fortran, arr.shape) || fortran) return arr;
  size_t n = 1;
  for (long d : arr.shape) n *= static_cast<size_t>(d);
  if (descr == "<f4") {
    arr.data.resize(n);
    f.read(reinterpret_cast<char*>(arr.data.data()), n * sizeof(float));
  } else if (descr == "<f8") {
    convert<double>(f, arr.data, n);
  } else if (descr == "<i4") {
    convert<int32_t>(f, arr.data, n);
  } else if (descr == "<i8") {
    convert<int64_t>(f, arr.data, n);
  } else {
    return arr;
  }
  arr.ok = static_cast<bool>(f);
  return arr;
}

struct Prefetcher {
  std::vector<std::string> paths;
  size_t ahead;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  // decoded[i] filled by workers; consumer takes them in order
  std::vector<NpyArray> decoded;
  std::vector<char> done;
  std::atomic<size_t> next_job{0};
  size_t next_consume = 0;
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> p, size_t ahead_, int n_threads)
      : paths(std::move(p)), ahead(ahead_), decoded(paths.size()),
        done(paths.size(), 0) {
    for (int t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { work(); });
    }
  }

  void work() {
    while (!stop.load()) {
      size_t job = next_job.fetch_add(1);
      if (job >= paths.size()) return;
      {
        // bound read-ahead: wait until the consumer is close
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || job < next_consume + ahead;
        });
        if (stop.load()) return;
      }
      NpyArray arr = load_npy(paths[job]);
      {
        std::lock_guard<std::mutex> lk(mu);
        decoded[job] = std::move(arr);
        done[job] = 1;
      }
      cv_ready.notify_all();
    }
  }

  bool next(float* out, long cap, long* shape, int* ndim) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (next_consume >= paths.size()) return false;
      idx = next_consume;
      cv_ready.wait(lk, [&] { return done[idx] != 0; });
    }
    NpyArray& arr = decoded[idx];
    // a file the parser does not take is handed back as a failure (the
    // caller reads it another way) and the queue moves past it
    bool ok = arr.ok && static_cast<long>(arr.data.size()) <= cap;
    if (ok) {
      std::memcpy(out, arr.data.data(), arr.data.size() * sizeof(float));
      *ndim = static_cast<int>(arr.shape.size());
      for (size_t i = 0; i < arr.shape.size(); ++i) shape[i] = arr.shape[i];
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      decoded[idx] = NpyArray();  // free
      ++next_consume;
    }
    cv_space.notify_all();
    return ok;
  }

  ~Prefetcher() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

// single-file API -------------------------------------------------------------

int stgx_npy_info(const char* path, long* shape, int* ndim) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  std::string descr;
  bool fortran;
  std::vector<long> s;
  if (!parse_header(f, descr, fortran, s) || fortran) return -2;
  *ndim = static_cast<int>(s.size());
  for (size_t i = 0; i < s.size(); ++i) shape[i] = s[i];
  return 0;
}

int stgx_npy_read_f32(const char* path, float* out, long cap) {
  NpyArray arr = load_npy(path);
  if (!arr.ok || static_cast<long>(arr.data.size()) > cap) return -1;
  std::memcpy(out, arr.data.data(), arr.data.size() * sizeof(float));
  return static_cast<int>(arr.shape.size());
}

// prefetcher API --------------------------------------------------------------

void* stgx_prefetch_open(const char** paths, int n, int ahead, int threads) {
  std::vector<std::string> p(paths, paths + n);
  return new Prefetcher(std::move(p), static_cast<size_t>(ahead),
                        threads > 0 ? threads : 2);
}

int stgx_prefetch_next(void* h, float* out, long cap, long* shape, int* ndim) {
  return static_cast<Prefetcher*>(h)->next(out, cap, shape, ndim) ? 0 : -1;
}

void stgx_prefetch_close(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"
