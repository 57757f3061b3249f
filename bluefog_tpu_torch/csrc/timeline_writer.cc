// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// Chrome-trace timeline writer of bluefog_tpu_torch: a background thread
// drains a queue of records into one JSON array, so recording a span from
// the training thread costs a lock and a queue push, not a formatted
// write. A copy of the JAX package's native/timeline_writer.cc, with the
// same records and escaping as bluefog_tpu_torch/timeline.py::_PyWriter.
//
// Built at the timeline's first use by bluefog_tpu_torch/_build.py:
//   g++ -O2 -std=c++17 -pthread -shared -fPIC -o <lib>.so timeline_writer.cc
// and loaded with ctypes.

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {

struct Record {
  long long ts_us;
  int pid;        // worker rank (chrome "process")
  long long tid;  // lane within the worker
  char ph;        // 'B' begin, 'E' end, 'X' complete, 'i' instant,
                  // 'C' counter
  long long dur_us;
  double value = 0.0;  // counter value ('C' records only)
  std::string name;
  std::string cat;
};

class TimelineWriter {
 public:
  // Static destruction must not leave a joinable thread behind (that is
  // std::terminate); Stop() is idempotent, so a forgotten
  // timeline_shutdown() degrades to a flush-at-exit instead of an abort.
  ~TimelineWriter() { Stop(); }

  bool Start(const char* path) {
    std::lock_guard<std::mutex> lk(control_mu_);
    if (file_ != nullptr) return false;
    file_ = std::fopen(path, "w");
    if (file_ == nullptr) return false;
    std::fputs("[\n", file_);
    first_ = true;
    stop_ = false;
    thread_ = std::thread(&TimelineWriter::Loop, this);
    return true;
  }

  void Add(Record&& r) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (file_ == nullptr) return;
      queue_.emplace_back(std::move(r));
    }
    cv_.notify_one();
  }

  void Stop() {
    std::lock_guard<std::mutex> lk(control_mu_);
    if (file_ == nullptr) return;
    {
      std::lock_guard<std::mutex> qlk(mu_);
      stop_ = true;
    }
    cv_.notify_one();
    thread_.join();
    std::fputs("\n]\n", file_);
    std::fclose(file_);
    file_ = nullptr;
  }

 private:
  void Loop() {
    std::deque<Record> batch;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        std::swap(batch, queue_);
        if (batch.empty() && stop_) return;
      }
      for (const Record& r : batch) Emit(r);
      std::fflush(file_);
      batch.clear();
    }
  }

  void Emit(const Record& r) {
    if (!first_) std::fputs(",\n", file_);
    first_ = false;
    // chrome://tracing JSON-array format
    std::fprintf(file_,
                 "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"%c\", "
                 "\"ts\": %lld, \"pid\": %d, \"tid\": %lld",
                 Escape(r.name).c_str(), Escape(r.cat).c_str(), r.ph,
                 r.ts_us, r.pid, r.tid);
    if (r.ph == 'X') std::fprintf(file_, ", \"dur\": %lld", r.dur_us);
    if (r.ph == 'i') std::fputs(", \"s\": \"p\"", file_);
    // counter events carry their series value in args (chrome renders
    // them as stacked area tracks)
    if (r.ph == 'C') std::fprintf(file_, ", \"args\": {\"value\": %g}", r.value);
    std::fputs("}", file_);
  }

  static std::string Escape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (char c : s) {
      if (c == '"' || c == '\\') out.push_back('\\');
      if (static_cast<unsigned char>(c) >= 0x20) out.push_back(c);
    }
    return out;
  }

  FILE* file_ = nullptr;
  bool first_ = true;
  bool stop_ = false;
  std::deque<Record> queue_;
  std::mutex mu_;
  std::mutex control_mu_;
  std::condition_variable cv_;
  std::thread thread_;
};

TimelineWriter g_writer;

long long NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

int bf_timeline_start(const char* path) { return g_writer.Start(path) ? 1 : 0; }

void bf_timeline_stop() { g_writer.Stop(); }

// ph: 'B' begin / 'E' end / 'i' instant; ts measured here so callers need
// no clock plumbing.
void bf_timeline_record(const char* name, const char* category, char ph,
                        int pid, long long tid) {
  Record r;
  r.ts_us = NowUs();
  r.pid = pid;
  r.tid = tid;
  r.ph = ph;
  r.dur_us = 0;
  r.name = name == nullptr ? "" : name;
  r.cat = category == nullptr ? "" : category;
  g_writer.Add(std::move(r));
}

// Complete event with explicit duration (for phases timed in Python).
void bf_timeline_record_complete(const char* name, const char* category,
                                 int pid, long long tid, long long ts_us,
                                 long long dur_us) {
  Record r;
  r.ts_us = ts_us;
  r.pid = pid;
  r.tid = tid;
  r.ph = 'X';
  r.dur_us = dur_us;
  r.name = name == nullptr ? "" : name;
  r.cat = category == nullptr ? "" : category;
  g_writer.Add(std::move(r));
}

// Counter event (ph 'C'): a named scalar sampled now (the timeline
// exporter of bluefog_tpu_torch/metrics.py).
void bf_timeline_record_counter(const char* name, const char* category,
                                int pid, long long tid, double value) {
  Record r;
  r.ts_us = NowUs();
  r.pid = pid;
  r.tid = tid;
  r.ph = 'C';
  r.dur_us = 0;
  r.value = value;
  r.name = name == nullptr ? "" : name;
  r.cat = category == nullptr ? "" : category;
  g_writer.Add(std::move(r));
}

long long bf_timeline_now_us() { return NowUs(); }

}  // extern "C"
