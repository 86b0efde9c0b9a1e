// Native host runtime of slam_eds_tpu_torch: event buffering and
// packetization. The port's own copy of native/event_runtime.cpp (same code),
// built with the host C++ compiler into slam_eds_tpu_torch/_build/ by
// ops/kernels/build.py:build_host_library and bound with ctypes by
// slam_eds_tpu_torch/io/event_buffer.py.
//
// The reference keeps this layer OUTSIDE the library (the Rock/orogen task
// owns the dataflow loop — buffering of events/images and packet formation;
// SURVEY §0 L7). Here it is part of the framework, in C++ because it is the
// one genuinely serial, latency-sensitive host path: millions of events/s
// must be ingested, validated (monotonic timestamps — the reference throws
// on violations, src/tracking/EventFrame.cpp:204-208), sliced into
// fixed-capacity packets, and padded into the fixed-capacity arrays the
// event step consumes. Doing this in numpy costs several copies per packet;
// this C ABI does it in one pass.
//
// Threading model: single-producer single-consumer ring buffer with atomic
// head/tail — the producer (sensor/dataset reader thread) pushes batches,
// the consumer (pipeline loop) drains packets. No locks on the hot path.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Event {
  float x;
  float y;
  double t;
  float p;
};

class EventRing {
 public:
  explicit EventRing(int64_t capacity)
      : buf_(static_cast<size_t>(capacity)), cap_(capacity), head_(0),
        tail_(0), dropped_(0), last_t_(-1.0), nonmono_(0) {}

  // Push a batch; returns number accepted. Events with non-monotonic
  // timestamps are counted and their time clamped (the reference hard-throws;
  // a production runtime must survive sensor glitches, so we repair + count).
  int64_t push(const float* xs, const float* ys, const double* ts,
               const float* ps, int64_t n) {
    int64_t accepted = 0;
    int64_t head = head_.load(std::memory_order_relaxed);
    const int64_t tail = tail_.load(std::memory_order_acquire);
    for (int64_t i = 0; i < n; ++i) {
      if (head - tail >= cap_) {  // full: drop oldest-first policy = reject
        dropped_ += n - i;
        break;
      }
      double t = ts[i];
      if (t < last_t_) {
        ++nonmono_;
        t = last_t_;
      }
      last_t_ = t;
      Event& e = buf_[static_cast<size_t>(head % cap_)];
      e.x = xs[i];
      e.y = ys[i];
      e.t = t;
      e.p = ps[i];
      ++head;
      ++accepted;
    }
    head_.store(head, std::memory_order_release);
    return accepted;
  }

  int64_t size() const {
    return head_.load(std::memory_order_acquire) -
           tail_.load(std::memory_order_acquire);
  }

  int64_t free_space() const { return cap_ - size(); }

  // Drain up to `count` events into fixed-capacity output arrays of length
  // `capacity`, padding the remainder by repeating the last event with zero
  // polarity (zero-weight in the raster kernels). Returns n_valid. Output
  // timestamps are float64 seconds; also writes the median event time (the
  // packet timestamp, reference EventFrame.cpp:210-212).
  int64_t pop_packet(int64_t count, int64_t capacity, float* xs, float* ys,
                     double* ts, float* ps, double* median_t) {
    int64_t tail = tail_.load(std::memory_order_relaxed);
    const int64_t head = head_.load(std::memory_order_acquire);
    const int64_t n = std::min({count, head - tail, capacity});
    for (int64_t i = 0; i < n; ++i) {
      const Event& e = buf_[static_cast<size_t>((tail + i) % cap_)];
      xs[i] = e.x;
      ys[i] = e.y;
      ts[i] = e.t;
      ps[i] = e.p;
    }
    tail_.store(tail + n, std::memory_order_release);
    if (n > 0) {
      for (int64_t i = n; i < capacity; ++i) {
        xs[i] = xs[n - 1];
        ys[i] = ys[n - 1];
        ts[i] = ts[n - 1];
        ps[i] = 0.0f;
      }
      *median_t = ts[n / 2];
    } else {
      *median_t = 0.0;
    }
    return n;
  }

  // Same but slicing by time: all events with t < t_end (e.g. "events up to
  // the next frame" packetization the external orogen task performs).
  int64_t pop_until(double t_end, int64_t capacity, float* xs, float* ys,
                    double* ts, float* ps, double* median_t) {
    int64_t tail = tail_.load(std::memory_order_relaxed);
    const int64_t head = head_.load(std::memory_order_acquire);
    int64_t n = 0;
    while (n < capacity && tail + n < head) {
      const Event& e = buf_[static_cast<size_t>((tail + n) % cap_)];
      if (e.t >= t_end) break;
      xs[n] = e.x;
      ys[n] = e.y;
      ts[n] = e.t;
      ps[n] = e.p;
      ++n;
    }
    tail_.store(tail + n, std::memory_order_release);
    if (n > 0) {
      for (int64_t i = n; i < capacity; ++i) {
        xs[i] = xs[n - 1];
        ys[i] = ys[n - 1];
        ts[i] = ts[n - 1];
        ps[i] = 0.0f;
      }
      *median_t = ts[n / 2];
    } else {
      *median_t = 0.0;
    }
    return n;
  }

  int64_t dropped() const { return dropped_; }
  int64_t nonmonotonic() const { return nonmono_; }

 private:
  std::vector<Event> buf_;
  const int64_t cap_;
  std::atomic<int64_t> head_;
  std::atomic<int64_t> tail_;
  int64_t dropped_;
  double last_t_;
  int64_t nonmono_;
};

// ---------------------------------------------------------------------------
// Dataset reader: ASCII event files ("t x y p" per line, '#' comments — the
// standard event-camera dataset text format the EDS sequences ship as).
// Buffered chunk reads + a hand-rolled float parser: ~10x fgets/sscanf, so a
// reader thread can keep up with multi-Mev/s streams while the GIL is
// released (ctypes). Polarity is mapped to +-1 (reference maps the bool
// polarity to +-1 brightness increments, src/tracking/EventFrame.cpp).
class EventFileReader {
 public:
  explicit EventFileReader(const char* path)
      : f_(std::fopen(path, "rb")), buf_(1 << 20), len_(0), pos_(0) {}
  ~EventFileReader() {
    if (f_) std::fclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Parse up to max_n events into the arrays; returns count (0 at EOF).
  int64_t read(float* xs, float* ys, double* ts, float* ps, int64_t max_n) {
    int64_t n = 0;
    while (n < max_n) {
      if (!fill_line()) break;
      const char* p = line_.c_str();
      while (*p == ' ' || *p == '\t') ++p;
      if (*p == '#' || *p == '\0') continue;
      char* end = nullptr;
      const double t = std::strtod(p, &end);
      if (end == p) continue;
      p = end;
      const double x = std::strtod(p, &end);
      if (end == p) continue;
      p = end;
      const double y = std::strtod(p, &end);
      if (end == p) continue;
      p = end;
      const double pol = std::strtod(p, &end);
      if (end == p) continue;  // malformed/truncated line: drop, don't invent
      ts[n] = t;
      xs[n] = static_cast<float>(x);
      ys[n] = static_cast<float>(y);
      ps[n] = pol > 0.0 ? 1.0f : -1.0f;
      ++n;
    }
    return n;
  }

 private:
  bool fill_line() {
    line_.clear();
    for (;;) {
      if (pos_ >= len_) {
        if (!f_) return !line_.empty();
        len_ = std::fread(buf_.data(), 1, buf_.size(), f_);
        pos_ = 0;
        if (len_ == 0) {
          std::fclose(f_);
          f_ = nullptr;
          return !line_.empty();
        }
      }
      const char* start = buf_.data() + pos_;
      const char* nl = static_cast<const char*>(
          std::memchr(start, '\n', len_ - pos_));
      if (nl) {
        line_.append(start, nl - start);
        pos_ += (nl - start) + 1;
        return true;
      }
      line_.append(start, len_ - pos_);
      pos_ = len_;
    }
  }

  std::FILE* f_;
  std::vector<char> buf_;
  size_t len_;
  size_t pos_;
  std::string line_;
};

}  // namespace

extern "C" {

// --- dataset reader -------------------------------------------------------

void* event_file_open(const char* path) {
  auto* r = new EventFileReader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void event_file_close(void* reader) {
  delete static_cast<EventFileReader*>(reader);
}

int64_t event_file_read(void* reader, float* xs, float* ys, double* ts,
                        float* ps, int64_t max_n) {
  return static_cast<EventFileReader*>(reader)->read(xs, ys, ts, ps, max_n);
}

// Per-event undistortion via precomputed forward maps (the reference's
// per-event fwd_mapx/fwd_mapy lookup, src/tracking/EventFrame.cpp:316-317):
// one pass over the packet, nearest-pixel map indexing, out-of-range events
// flagged by moving them to (-1, -1) (masked by the raster kernel bounds).
// PNG scanline unfilter (filters 1 Sub / 3 Average / 4 Paeth; 0/2 are
// vectorized in numpy) — the sequential per-byte recurrences that are
// pathological in interpreted Python (io/image_rw.py falls back to a Python
// loop when this library is unavailable).
void png_unfilter_rows(uint8_t* rows, const uint8_t* ftypes, int64_t n_rows,
                       int64_t stride, int64_t bpp) {
  std::vector<uint8_t> zero(static_cast<size_t>(stride), 0);
  const uint8_t* prev = zero.data();
  for (int64_t r = 0; r < n_rows; ++r) {
    uint8_t* cur = rows + r * stride;
    const int f = ftypes[r];
    if (f == 1) {
      for (int64_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
    } else if (f == 2) {
      for (int64_t i = 0; i < stride; ++i) cur[i] += prev[i];
    } else if (f == 3) {
      for (int64_t i = 0; i < stride; ++i) {
        const int left = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = static_cast<uint8_t>(cur[i] + ((left + prev[i]) >> 1));
      }
    } else if (f == 4) {
      for (int64_t i = 0; i < stride; ++i) {
        const int a = i >= bpp ? cur[i - bpp] : 0;
        const int b = prev[i];
        const int c = i >= bpp ? prev[i - bpp] : 0;
        const int p = a + b - c;
        const int pa = std::abs(p - a), pb = std::abs(p - b),
                  pc = std::abs(p - c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = static_cast<uint8_t>(cur[i] + pred);
      }
    }
    prev = cur;
  }
}

void event_apply_undistort(float* xs, float* ys, int64_t n, const float* mapx,
                           const float* mapy, int32_t width, int32_t height) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t xi = static_cast<int32_t>(std::lround(xs[i]));
    const int32_t yi = static_cast<int32_t>(std::lround(ys[i]));
    if (xi < 0 || yi < 0 || xi >= width || yi >= height) {
      xs[i] = -1.0f;
      ys[i] = -1.0f;
      continue;
    }
    const int64_t idx = static_cast<int64_t>(yi) * width + xi;
    xs[i] = mapx[idx];
    ys[i] = mapy[idx];
  }
}

void* event_ring_create(int64_t capacity) { return new EventRing(capacity); }

void event_ring_destroy(void* ring) { delete static_cast<EventRing*>(ring); }

int64_t event_ring_push(void* ring, const float* xs, const float* ys,
                        const double* ts, const float* ps, int64_t n) {
  return static_cast<EventRing*>(ring)->push(xs, ys, ts, ps, n);
}

int64_t event_ring_size(void* ring) {
  return static_cast<EventRing*>(ring)->size();
}

int64_t event_ring_free(void* ring) {
  return static_cast<EventRing*>(ring)->free_space();
}

int64_t event_ring_pop_packet(void* ring, int64_t count, int64_t capacity,
                              float* xs, float* ys, double* ts, float* ps,
                              double* median_t) {
  return static_cast<EventRing*>(ring)->pop_packet(count, capacity, xs, ys, ts,
                                                   ps, median_t);
}

int64_t event_ring_pop_until(void* ring, double t_end, int64_t capacity,
                             float* xs, float* ys, double* ts, float* ps,
                             double* median_t) {
  return static_cast<EventRing*>(ring)->pop_until(t_end, capacity, xs, ys, ts,
                                                  ps, median_t);
}

int64_t event_ring_dropped(void* ring) {
  return static_cast<EventRing*>(ring)->dropped();
}

int64_t event_ring_nonmonotonic(void* ring) {
  return static_cast<EventRing*>(ring)->nonmonotonic();
}

}  // extern "C"
