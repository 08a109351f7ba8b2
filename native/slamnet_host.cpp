// slamnet_host — native host runtime for the slamnet_tpu SLAM framework.
//
// The accelerator counterpart of the reference's host runtime: where slam.net
// runs a persistent thread pool + signaling queue for intra-scan parallelism
// (BaseSLAM/ParallelWorker.cs, SignalConcurrentQueue.cs), an accelerator's
// host side is an IO pipeline: ingest lidar revolutions, de-skew/pack them into
// fixed-shape device-ready buffers, and hand them to the accelerator without
// blocking the sensor thread.  This library provides:
//
//   * ScanQueue  — bounded MPSC blocking ring buffer of fixed-size scan slots
//                  (mutex + condvar signaling; the SignalConcurrentQueue role)
//   * slog codec — binary scan-log file format (header + CRC32-checked records)
//                  for trajectory replay datasets
//   * pack_polar — polar->cartesian conversion + per-segment de-skew into the
//                  framework's fixed-shape (points, valid) layout
//                  (ScanSegmentsToCloud contract, CoreSLAMProcessor.cs:187-207)
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ScanQueue

struct ScanQueue {
  std::vector<uint8_t> buf;
  size_t slot_bytes = 0;
  size_t capacity = 0;
  size_t head = 0;  // next pop
  size_t tail = 0;  // next push
  size_t count = 0;
  uint64_t dropped = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_push;  // signaled on pop (space available)
  std::condition_variable cv_pop;   // signaled on push (data available)
};

ScanQueue* sq_create(size_t capacity, size_t slot_bytes) {
  auto* q = new ScanQueue();
  q->slot_bytes = slot_bytes;
  q->capacity = capacity;
  q->buf.resize(capacity * slot_bytes);
  return q;
}

void sq_destroy(ScanQueue* q) { delete q; }

void sq_close(ScanQueue* q) {
  std::lock_guard<std::mutex> l(q->mu);
  q->closed = true;
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

// push with timeout_ms; timeout<0 blocks forever; timeout==0 drops when full
// (sensor threads must never stall — the drop counter records backpressure).
// returns 1 on success, 0 on drop/timeout, -1 if closed.
int sq_push(ScanQueue* q, const uint8_t* data, int64_t timeout_ms) {
  std::unique_lock<std::mutex> l(q->mu);
  auto full = [q] { return q->count >= q->capacity; };
  if (full() && timeout_ms == 0) {
    q->dropped++;
    return 0;
  }
  auto pred = [q] { return q->count < q->capacity || q->closed; };
  if (timeout_ms < 0) {
    q->cv_push.wait(l, pred);
  } else if (!q->cv_push.wait_for(l, std::chrono::milliseconds(timeout_ms),
                                  pred)) {
    q->dropped++;
    return 0;
  }
  if (q->closed) return -1;
  std::memcpy(&q->buf[q->tail * q->slot_bytes], data, q->slot_bytes);
  q->tail = (q->tail + 1) % q->capacity;
  q->count++;
  q->cv_pop.notify_one();
  return 1;
}

// pop with timeout semantics as push. returns 1/0/-1.
int sq_pop(ScanQueue* q, uint8_t* out, int64_t timeout_ms) {
  std::unique_lock<std::mutex> l(q->mu);
  auto pred = [q] { return q->count > 0 || q->closed; };
  if (timeout_ms < 0) {
    q->cv_pop.wait(l, pred);
  } else if (!q->cv_pop.wait_for(l, std::chrono::milliseconds(timeout_ms),
                                 pred)) {
    return 0;
  }
  if (q->count == 0) return q->closed ? -1 : 0;
  std::memcpy(out, &q->buf[q->head * q->slot_bytes], q->slot_bytes);
  q->head = (q->head + 1) % q->capacity;
  q->count--;
  q->cv_push.notify_one();
  return 1;
}

size_t sq_size(ScanQueue* q) {
  std::lock_guard<std::mutex> l(q->mu);
  return q->count;
}

uint64_t sq_dropped(ScanQueue* q) {
  std::lock_guard<std::mutex> l(q->mu);
  return q->dropped;
}

// ------------------------------------------------------------------- CRC32

static uint32_t crc_table[256];
static std::atomic<bool> crc_init{false};

static void init_crc() {
  bool expected = false;
  if (!crc_init.compare_exchange_strong(expected, true)) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
}

uint32_t slam_crc32(const uint8_t* data, size_t n) {
  init_crc();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// --------------------------------------------------------------- slog codec
//
// File layout (little endian):
//   magic "SLOG" | u32 version=1 | u32 num_beams | u32 reserved
//   records: u64 timestamp_ns | f32 odom[3] | f32 radii[num_beams]
//            | u8 valid[ceil(num_beams/8)] | u32 crc32(record payload)

struct SlogWriter {
  FILE* f = nullptr;
  uint32_t num_beams = 0;
};

struct SlogReader {
  FILE* f = nullptr;
  uint32_t num_beams = 0;
};

static size_t record_payload_bytes(uint32_t n) {
  return 8 + 12 + 4 * (size_t)n + (n + 7) / 8;
}

SlogWriter* slog_open_write(const char* path, uint32_t num_beams) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  const char magic[4] = {'S', 'L', 'O', 'G'};
  uint32_t version = 1, reserved = 0;
  fwrite(magic, 1, 4, f);
  fwrite(&version, 4, 1, f);
  fwrite(&num_beams, 4, 1, f);
  fwrite(&reserved, 4, 1, f);
  auto* w = new SlogWriter();
  w->f = f;
  w->num_beams = num_beams;
  return w;
}

int slog_append(SlogWriter* w, uint64_t ts_ns, const float* odom,
                const float* radii, const uint8_t* valid_bits) {
  size_t pn = record_payload_bytes(w->num_beams);
  std::vector<uint8_t> rec(pn);
  uint8_t* p = rec.data();
  std::memcpy(p, &ts_ns, 8); p += 8;
  std::memcpy(p, odom, 12); p += 12;
  std::memcpy(p, radii, 4 * w->num_beams); p += 4 * w->num_beams;
  std::memcpy(p, valid_bits, (w->num_beams + 7) / 8);
  uint32_t crc = slam_crc32(rec.data(), pn);
  if (fwrite(rec.data(), 1, pn, w->f) != pn) return -1;
  if (fwrite(&crc, 4, 1, w->f) != 1) return -1;
  return 0;
}

void slog_close_write(SlogWriter* w) {
  if (w->f) fclose(w->f);
  delete w;
}

SlogReader* slog_open_read(const char* path, uint32_t* num_beams_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  uint32_t version, nb, reserved;
  if (fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "SLOG", 4) != 0 ||
      fread(&version, 4, 1, f) != 1 || version != 1 ||
      fread(&nb, 4, 1, f) != 1 || fread(&reserved, 4, 1, f) != 1) {
    fclose(f);
    return nullptr;
  }
  auto* r = new SlogReader();
  r->f = f;
  r->num_beams = nb;
  *num_beams_out = nb;
  return r;
}

// returns 1 on success, 0 on EOF, -1 on corrupt record (CRC mismatch)
int slog_read(SlogReader* r, uint64_t* ts_ns, float* odom, float* radii,
              uint8_t* valid_bits) {
  size_t pn = record_payload_bytes(r->num_beams);
  std::vector<uint8_t> rec(pn);
  if (fread(rec.data(), 1, pn, r->f) != pn) return 0;
  uint32_t crc;
  if (fread(&crc, 4, 1, r->f) != 1) return 0;
  if (crc != slam_crc32(rec.data(), pn)) return -1;
  const uint8_t* p = rec.data();
  std::memcpy(ts_ns, p, 8); p += 8;
  std::memcpy(odom, p, 12); p += 12;
  std::memcpy(radii, p, 4 * r->num_beams); p += 4 * r->num_beams;
  std::memcpy(valid_bits, p, (r->num_beams + 7) / 8);
  return 1;
}

void slog_close_read(SlogReader* r) {
  if (r->f) fclose(r->f);
  delete r;
}

// -------------------------------------------------------------- pack_polar
//
// Convert S segments of polar rays into the fixed-shape cartesian cloud with
// the reference's de-skew contract (segment pose relative to the LAST
// segment's pose, component-wise; CoreSLAMProcessor.cs:187-207).
// angles/radii: [S * N]; seg_poses: [S * 3]; out_points: [S * N * 2].

void pack_polar_deskew(const float* angles, const float* radii,
                       const uint8_t* valid, const float* seg_poses,
                       int num_segments, int rays_per_segment,
                       float* out_points, uint8_t* out_valid) {
  const float* last_pose = seg_poses + 3 * (num_segments - 1);
  for (int s = 0; s < num_segments; s++) {
    float px = seg_poses[3 * s + 0] - last_pose[0];
    float py = seg_poses[3 * s + 1] - last_pose[1];
    float pth = seg_poses[3 * s + 2] - last_pose[2];
    for (int i = 0; i < rays_per_segment; i++) {
      int k = s * rays_per_segment + i;
      float a = angles[k] + pth;
      out_points[2 * k + 0] = px + radii[k] * std::cos(a);
      out_points[2 * k + 1] = py + radii[k] * std::sin(a);
      out_valid[k] = valid[k];
    }
  }
}

// ----------------------------------------------------------- CARMEN reader
//
// Native parser for the CARMEN log format (Radish corpus: FLASER scans +
// odometry; the real-robot ingestion path, io/datasets.py is the Python
// twin).  Two-pass C ABI: carmen_scan_count sizes the log, carmen_read fills
// caller-allocated fixed-shape buffers.  Handles:
//   FLASER n r_1..r_n  lx ly lth  ox oy oth  ts host log_ts
//   # TRUTH x y th          (ground truth for the NEXT scan; simulator logs)
//   PARAM <name with "maxrange"/"laser_max"> <value>
// ROBOTLASER1 and other line types are skipped (the Python reader covers
// them; every Radish FLASER log parses here).

namespace {

// CARMEN lines are space-separated ASCII floats.
inline const char* next_tok(const char* p) {
  while (*p == ' ' || *p == '\t') p++;
  return p;
}

}  // namespace

// Returns the number of FLASER scans (up to max_scans; <= 0 on error) and
// sets *n_beams (beam count of the first scan; mixed counts -> error -2),
// *max_range (from a PARAM line, else 0) and *has_truth.
int64_t carmen_scan_count(const char* path, int64_t* n_beams,
                          double* max_range, int32_t* has_truth,
                          int64_t max_scans) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int64_t scans = 0, beams = 0, truths = 0;
  *max_range = 0.0;
  std::vector<char> line(1 << 20);
  while (fgets(line.data(), (int)line.size(), f)) {
    const char* p = next_tok(line.data());
    if (std::strncmp(p, "# TRUTH ", 8) == 0) { truths++; continue; }
    if (*p == '#') continue;
    if (std::strncmp(p, "PARAM ", 6) == 0) {
      const char* name = next_tok(p + 6);
      const char* sp = name;
      while (*sp && *sp != ' ' && *sp != '\t') sp++;
      std::string nm(name, sp - name);
      if (nm.find("maxrange") != std::string::npos ||
          (nm.size() > 9 && nm.rfind("laser_max") == nm.size() - 9)) {
        *max_range = strtod(sp, nullptr);
      }
      continue;
    }
    if (std::strncmp(p, "FLASER ", 7) == 0) {
      char* end;
      long n = strtol(p + 7, &end, 10);
      if (n <= 0) { fclose(f); return -3; }
      if (beams == 0) beams = n;
      else if (beams != n) { fclose(f); return -2; }
      scans++;
      if (max_scans > 0 && scans >= max_scans) break;
    }
  }
  fclose(f);
  *n_beams = beams;
  // Exact 1:1 like the Python twin (io/datasets.read_carmen requires
  // len(truth) == len(scans)); stray/extra '# TRUTH' lines -> no truth.
  *has_truth = (truths == scans && scans > 0) ? 1 : 0;
  return scans;
}

// Fill ranges [T*N] f32, odom [T*3] f32, truth [T*3] f32 (zeros when the log
// carries none), stamps [T] f64.  Returns scans filled (<= 0 on error).
int64_t carmen_read(const char* path, int64_t max_scans, int64_t n_beams,
                    float* ranges, float* odom, float* truth, double* stamps) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int64_t t = 0;
  bool have_truth = false;
  float pending_truth[3] = {0, 0, 0};
  std::vector<char> line(1 << 20);
  while (t < max_scans && fgets(line.data(), (int)line.size(), f)) {
    char* p = const_cast<char*>(next_tok(line.data()));
    if (std::strncmp(p, "# TRUTH ", 8) == 0) {
      char* q = p + 8;
      // strtod + cast (not strtof): bit-identical to the Python reader's
      // float(text) -> np.float32 double-rounding path
      for (int i = 0; i < 3; i++) pending_truth[i] = (float)strtod(q, &q);
      have_truth = true;
      continue;
    }
    if (*p == '#') continue;
    if (std::strncmp(p, "FLASER ", 7) != 0) continue;
    char* q = p + 7;
    long n = strtol(q, &q, 10);
    if (n != n_beams) { fclose(f); return -2; }
    float* r = ranges + t * n_beams;
    for (long i = 0; i < n; i++) {
      char* q0 = q;
      r[i] = (float)strtod(q, &q);
      // token-count validation (Python-twin contract: a truncated FLASER
      // line errors instead of silently zero-filling)
      if (q == q0) { fclose(f); return -4; }
    }
    float lx = (float)strtod(q, &q), ly = (float)strtod(q, &q),
          lth = (float)strtod(q, &q);
    // skip odom x y th (FLASER duplicates the laser pose in our writer;
    // real logs carry the robot odometry here -- the laser pose fields are
    // the reader contract, matching io/datasets.read_carmen)
    strtod(q, &q); strtod(q, &q); strtod(q, &q);
    double ts = strtod(q, &q);
    odom[3 * t + 0] = lx; odom[3 * t + 1] = ly; odom[3 * t + 2] = lth;
    stamps[t] = ts;
    if (have_truth) {
      truth[3 * t + 0] = pending_truth[0];
      truth[3 * t + 1] = pending_truth[1];
      truth[3 * t + 2] = pending_truth[2];
      have_truth = false;
    }
    t++;
  }
  fclose(f);
  return t;
}

}  // extern "C"

