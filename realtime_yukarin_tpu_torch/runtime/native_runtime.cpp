// Native host runtime: lock-free SPSC ring buffers, fixed-chunk assembly,
// and WAV file I/O.  The PyTorch port's own copy of the JAX package's
// runtime/native_runtime.cpp (the port imports nothing of that package).
//
// Role (SURVEY.md §1 L5/L6): the reference moves audio between a PortAudio
// callback thread and worker processes through multiprocessing.Queues with
// pickling.  Here the per-chunk pipeline is one device step, so the
// host runtime's job shrinks to what actually needs native code: realtime-
// safe (allocation-free, lock-free) buffering between the audio edge and
// the Python dispatch loop, plus fast file I/O for the offline/data paths.
//
// Single-producer/single-consumer discipline matches the reference's queue
// topology (§5 race-detection row: race-free by construction).
//
// Build: g++ -O3 -shared -fPIC at first use (runtime/__init__.py).
// C ABI for ctypes.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC float ring buffer
// ---------------------------------------------------------------------------

struct RingBuffer {
  float* data;
  uint64_t capacity;                 // power of two
  std::atomic<uint64_t> head;        // write position (producer)
  std::atomic<uint64_t> tail;        // read position (consumer)
  std::atomic<uint64_t> underruns;   // pop_exact misses
  std::atomic<uint64_t> overruns;    // push drops
};

static uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

RingBuffer* rb_create(uint64_t min_capacity) {
  auto* rb = new RingBuffer();
  rb->capacity = next_pow2(min_capacity);
  rb->data = static_cast<float*>(std::malloc(rb->capacity * sizeof(float)));
  rb->head.store(0);
  rb->tail.store(0);
  rb->underruns.store(0);
  rb->overruns.store(0);
  return rb;
}

void rb_destroy(RingBuffer* rb) {
  if (!rb) return;
  std::free(rb->data);
  delete rb;
}

uint64_t rb_capacity(const RingBuffer* rb) { return rb->capacity; }

uint64_t rb_available(const RingBuffer* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

uint64_t rb_free_space(const RingBuffer* rb) {
  return rb->capacity - rb_available(rb);
}

// Push up to n samples; returns number actually pushed (drops the rest and
// counts an overrun — the "pipeline fell behind" contract of the
// reference's main loop).
uint64_t rb_push(RingBuffer* rb, const float* src, uint64_t n) {
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t tail = rb->tail.load(std::memory_order_acquire);
  uint64_t free_n = rb->capacity - (head - tail);
  uint64_t push_n = n < free_n ? n : free_n;
  if (push_n < n) rb->overruns.fetch_add(1, std::memory_order_relaxed);
  const uint64_t mask = rb->capacity - 1;
  uint64_t pos = head & mask;
  uint64_t first = push_n < (rb->capacity - pos) ? push_n
                                                 : (rb->capacity - pos);
  std::memcpy(rb->data + pos, src, first * sizeof(float));
  std::memcpy(rb->data, src + first, (push_n - first) * sizeof(float));
  rb->head.store(head + push_n, std::memory_order_release);
  return push_n;
}

// Pop up to n samples; returns number actually popped.
uint64_t rb_pop(RingBuffer* rb, float* dst, uint64_t n) {
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  uint64_t head = rb->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t pop_n = n < avail ? n : avail;
  const uint64_t mask = rb->capacity - 1;
  uint64_t pos = tail & mask;
  uint64_t first = pop_n < (rb->capacity - pos) ? pop_n
                                                : (rb->capacity - pos);
  std::memcpy(dst, rb->data + pos, first * sizeof(float));
  std::memcpy(dst + first, rb->data, (pop_n - first) * sizeof(float));
  rb->tail.store(tail + pop_n, std::memory_order_release);
  return pop_n;
}

// Pop EXACTLY n samples or, if not enough data, fill dst with silence and
// count an underrun (reference run.py: silence on underrun, SURVEY.md §5).
int rb_pop_exact_or_silence(RingBuffer* rb, float* dst, uint64_t n) {
  if (rb_available(rb) >= n) {
    rb_pop(rb, dst, n);
    return 1;
  }
  std::memset(dst, 0, n * sizeof(float));
  rb->underruns.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

uint64_t rb_underruns(const RingBuffer* rb) { return rb->underruns.load(); }
uint64_t rb_overruns(const RingBuffer* rb) { return rb->overruns.load(); }

// ---------------------------------------------------------------------------
// WAV I/O (16-bit PCM and float32, mono-ified)
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
  int64_t num_frames;   // per channel
  int32_t format;       // 1 = PCM, 3 = float
};

static int read_chunk_header(FILE* f, char id[4], uint32_t* size) {
  if (std::fread(id, 1, 4, f) != 4) return 0;
  if (std::fread(size, 4, 1, f) != 1) return 0;
  return 1;
}

int wav_read_info(const char* path, WavInfo* info) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char id[4];
  uint32_t size;
  if (!read_chunk_header(f, id, &size) || std::memcmp(id, "RIFF", 4)) {
    std::fclose(f);
    return -2;
  }
  char wave[4];
  if (std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return -2;
  }
  int have_fmt = 0;
  while (read_chunk_header(f, id, &size)) {
    if (!std::memcmp(id, "fmt ", 4)) {
      uint16_t fmt, ch, block, bits;
      uint32_t rate, byterate;
      std::fread(&fmt, 2, 1, f);
      std::fread(&ch, 2, 1, f);
      std::fread(&rate, 4, 1, f);
      std::fread(&byterate, 4, 1, f);
      std::fread(&block, 2, 1, f);
      std::fread(&bits, 2, 1, f);
      if (size > 16) std::fseek(f, size - 16, SEEK_CUR);
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = static_cast<int32_t>(rate);
      info->bits = bits;
      have_fmt = 1;
    } else if (!std::memcmp(id, "data", 4)) {
      if (!have_fmt) {
        std::fclose(f);
        return -3;
      }
      info->num_frames = static_cast<int64_t>(size) /
                         (info->channels * (info->bits / 8));
      std::fclose(f);
      return 0;
    } else {
      std::fseek(f, (size + 1) & ~1u, SEEK_CUR);
    }
  }
  std::fclose(f);
  return -3;
}

// Reads the whole file as mono float32 (channel-averaged).  dst must have
// room for info.num_frames floats.  Returns frames read or <0 on error.
int64_t wav_read_f32(const char* path, float* dst, int64_t max_frames) {
  WavInfo info;
  int rc = wav_read_info(path, &info);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // re-scan to the data chunk
  std::fseek(f, 12, SEEK_SET);
  char id[4];
  uint32_t size = 0;
  while (read_chunk_header(f, id, &size)) {
    if (!std::memcmp(id, "data", 4)) break;
    std::fseek(f, (size + 1) & ~1u, SEEK_CUR);
  }
  int64_t frames = info.num_frames < max_frames ? info.num_frames
                                                : max_frames;
  const int ch = info.channels;
  const int64_t block = 4096;
  if (info.bits == 16 && info.format == 1) {
    int16_t* buf = static_cast<int16_t*>(
        std::malloc(block * ch * sizeof(int16_t)));
    int64_t done = 0;
    while (done < frames) {
      int64_t want = frames - done < block ? frames - done : block;
      size_t got = std::fread(buf, sizeof(int16_t) * ch, want, f);
      if (got == 0) break;
      for (size_t i = 0; i < got; ++i) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += buf[i * ch + c];
        dst[done + i] = acc / (32768.0f * ch);
      }
      done += got;
    }
    std::free(buf);
    std::fclose(f);
    return done;
  }
  if (info.bits == 32 && info.format == 3) {
    float* buf = static_cast<float*>(std::malloc(block * ch * sizeof(float)));
    int64_t done = 0;
    while (done < frames) {
      int64_t want = frames - done < block ? frames - done : block;
      size_t got = std::fread(buf, sizeof(float) * ch, want, f);
      if (got == 0) break;
      for (size_t i = 0; i < got; ++i) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += buf[i * ch + c];
        dst[done + i] = acc / ch;
      }
      done += got;
    }
    std::free(buf);
    std::fclose(f);
    return done;
  }
  std::fclose(f);
  return -4;  // unsupported encoding
}

int wav_write_f32(const char* path, const float* src, int64_t frames,
                  int32_t sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_size = static_cast<uint32_t>(frames * 2);
  uint32_t riff_size = 36 + data_size;
  uint16_t fmt = 1, ch = 1, bits = 16, block = 2;
  uint32_t rate = static_cast<uint32_t>(sample_rate);
  uint32_t byterate = rate * block;
  uint32_t fmt_size = 16;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_size, 4, 1, f);
  std::fwrite("WAVE", 1, 4, f);
  std::fwrite("fmt ", 1, 4, f);
  std::fwrite(&fmt_size, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  std::fwrite(&ch, 2, 1, f);
  std::fwrite(&rate, 4, 1, f);
  std::fwrite(&byterate, 4, 1, f);
  std::fwrite(&block, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_size, 4, 1, f);
  const int64_t blockn = 4096;
  int16_t buf[4096];
  int64_t done = 0;
  while (done < frames) {
    int64_t want = frames - done < blockn ? frames - done : blockn;
    for (int64_t i = 0; i < want; ++i) {
      float v = src[done + i];
      if (v > 1.f) v = 1.f;
      if (v < -1.f) v = -1.f;
      buf[i] = static_cast<int16_t>(std::lrintf(v * 32767.0f));
    }
    std::fwrite(buf, sizeof(int16_t), want, f);
    done += want;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
