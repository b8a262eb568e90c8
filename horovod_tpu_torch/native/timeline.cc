// Native timeline recorder — chrome-trace JSON writer.
//
// Host-side equivalent of the reference's C++ Timeline
// (horovod/common/timeline.cc:205-290: lock-free SPSC queue feeding a
// dedicated writer thread, so the hot collective-dispatch path never
// blocks on file IO). Here: a Vyukov-style MPSC ring buffer (per-slot
// sequence numbers make producer writes visible to the writer without
// locks) drained by a std::thread; events are dropped (and counted)
// rather than blocking when the buffer is full — the policy a profiler
// wants on the dispatch path.
//
// C ABI (consumed via ctypes from horovod_tpu_torch/common/timeline.py):
//   hvt_timeline_start(path)        -> 0 ok
//   hvt_timeline_event(tid, name, phase, ts_us)   phase: 'B','E','i'
//   hvt_timeline_stop()             flush + close (writes valid JSON)
//   hvt_timeline_dropped()          -> events dropped due to full buffer

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::atomic<uint64_t> seq{0};
  char tid[64];
  char name[64];
  char phase;
  double ts_us;
};

constexpr size_t kCapacity = 1 << 16;  // 65536 in-flight events

struct Recorder {
  std::vector<Slot> ring;
  std::atomic<uint64_t> head{0};   // next write ticket (producers)
  uint64_t tail = 0;               // next read ticket (writer thread only)
  std::atomic<uint64_t> dropped{0};
  std::atomic<bool> running{false};
  std::thread writer;
  FILE* out = nullptr;
  bool first = true;

  Recorder() : ring(kCapacity) { Reset(); }

  void Reset() {
    head.store(0);
    tail = 0;
    first = true;
    for (size_t i = 0; i < kCapacity; ++i) ring[i].seq.store(i);
  }

  void WriterLoop() {
    for (;;) {
      Slot& s = ring[tail % kCapacity];
      if (s.seq.load(std::memory_order_acquire) == tail + 1) {
        fprintf(out,
                "%s{\"name\":\"%s\",\"ph\":\"%c\",\"ts\":%.3f,"
                "\"pid\":0,\"tid\":\"%s\"%s}",
                first ? "" : ",\n", s.name, s.phase, s.ts_us, s.tid,
                s.phase == 'i' ? ",\"s\":\"g\"" : "");
        first = false;
        // Recycle the slot for lap tail/kCapacity + 1.
        s.seq.store(tail + kCapacity, std::memory_order_release);
        ++tail;
        continue;
      }
      if (!running.load(std::memory_order_acquire) &&
          tail == head.load(std::memory_order_acquire)) {
        return;
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  }
};

// A single never-deleted recorder instance: producers that race with
// stop() see running==false at worst — no use-after-free is possible
// because the object outlives the process (the reference's Timeline is
// likewise a process-lifetime singleton, horovod/common/timeline.h).
Recorder& TheRecorder() {
  static Recorder* r = new Recorder();
  return *r;
}
std::mutex g_mu;

}  // namespace

extern "C" {

int hvt_timeline_start(const char* path) {
  std::lock_guard<std::mutex> lk(g_mu);
  Recorder& r = TheRecorder();
  if (r.running.load(std::memory_order_acquire)) return 1;
  r.out = fopen(path, "w");
  if (r.out == nullptr) return 2;
  r.Reset();
  fprintf(r.out, "{\"displayTimeUnit\":\"ms\",\"traceEvents\":[\n");
  r.running.store(true, std::memory_order_release);
  r.writer = std::thread([&r] { r.WriterLoop(); });
  return 0;
}

void hvt_timeline_event(const char* tid, const char* name, char phase,
                        double ts_us) {
  Recorder& r = TheRecorder();
  if (!r.running.load(std::memory_order_acquire)) return;
  // Vyukov enqueue with fail-on-full: claim a ticket only when its slot is
  // free (seq == ticket), so every claimed ticket IS written and the
  // writer never waits on a hole. seq > ticket just means another
  // producer won this ticket — reload head and retry; only seq < ticket
  // (previous lap unconsumed) means the ring is genuinely full.
  uint64_t ticket = r.head.load(std::memory_order_relaxed);
  for (;;) {
    Slot& s = r.ring[ticket % kCapacity];
    uint64_t seq = s.seq.load(std::memory_order_acquire);
    if (seq == ticket) {
      if (r.head.compare_exchange_weak(ticket, ticket + 1,
                                       std::memory_order_acq_rel)) {
        snprintf(s.tid, sizeof(s.tid), "%s", tid);
        snprintf(s.name, sizeof(s.name), "%s", name);
        s.phase = phase;
        s.ts_us = ts_us;
        s.seq.store(ticket + 1, std::memory_order_release);
        return;
      }
      // CAS lost: `ticket` was refreshed by compare_exchange, retry.
    } else if ((int64_t)(seq - ticket) < 0) {
      r.dropped.fetch_add(1, std::memory_order_relaxed);
      return;  // full: drop rather than block the dispatch path
    } else {
      ticket = r.head.load(std::memory_order_relaxed);
    }
  }
}

uint64_t hvt_timeline_dropped() { return TheRecorder().dropped.load(); }

int hvt_timeline_stop() {
  std::lock_guard<std::mutex> lk(g_mu);
  Recorder& r = TheRecorder();
  if (!r.running.load(std::memory_order_acquire)) return 1;
  r.running.store(false, std::memory_order_release);
  r.writer.join();
  fprintf(r.out, "\n]}\n");
  fclose(r.out);
  r.out = nullptr;
  return 0;
}

}  // extern "C"
