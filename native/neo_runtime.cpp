// neojax native runtime: WAV codec + real-time re-blocker.
//
// The device compute path is JAX/XLA; this is the host-side runtime that
// surrounds it — the role the reference implements in C++ for its CLI and
// plugin (WAV I/O, extra/cli/src/wav.hpp:50,89; frame re-blocking with
// latency management, extra/plugin/src/dsp/ConstantOverlapAdd.hpp:12,89-199).
// Exposed through a plain C ABI and loaded from Python with ctypes
// (neojax/io/native.py).
//
// Build: make -C native   (produces libneo_runtime.so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- WAV codec

// Probe a RIFF/WAVE buffer. Returns 0 on success, negative error otherwise.
// format: 1 = integer PCM, 3 = IEEE float.
int neo_wav_probe(const uint8_t* data, uint64_t size, int32_t* channels,
                  int32_t* sample_rate, int32_t* bits, int32_t* format,
                  uint64_t* frames) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    return -1;
  }
  uint64_t pos = 12;
  bool have_fmt = false;
  uint64_t data_size = 0;
  uint16_t fmt_code = 0, nch = 0, nbits = 0;
  uint32_t rate = 0;
  while (pos + 8 <= size) {
    const uint8_t* chunk = data + pos;
    uint32_t chunk_size;
    std::memcpy(&chunk_size, chunk + 4, 4);
    const uint8_t* payload = chunk + 8;
    if (std::memcmp(chunk, "fmt ", 4) == 0 && chunk_size >= 16) {
      std::memcpy(&fmt_code, payload, 2);
      std::memcpy(&nch, payload + 2, 2);
      std::memcpy(&rate, payload + 4, 4);
      std::memcpy(&nbits, payload + 14, 2);
      if (fmt_code == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: real code = first 2 bytes of the
        // SubFormat GUID at fmt offset 24.
        if (chunk_size < 40 || pos + 8 + 26 > size) return -2;
        std::memcpy(&fmt_code, payload + 24, 2);
      }
      have_fmt = true;
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      data_size = std::min<uint64_t>(chunk_size, size - pos - 8);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!have_fmt || data_size == 0 || nch == 0 || nbits == 0) return -2;
  if (fmt_code != 1 && fmt_code != 3) return -3;
  *channels = nch;
  *sample_rate = static_cast<int32_t>(rate);
  *bits = nbits;
  *format = fmt_code;
  *frames = data_size / (nch * (nbits / 8));
  return 0;
}

// Decode into planar float32 [channels][frames]. Caller sizes `out` from
// neo_wav_probe. Returns 0 on success.
int neo_wav_decode(const uint8_t* data, uint64_t size, float* out) {
  int32_t nch, rate, bits, format;
  uint64_t frames;
  int rc = neo_wav_probe(data, size, &nch, &rate, &bits, &format, &frames);
  if (rc != 0) return rc;

  // Find the data chunk again.
  uint64_t pos = 12;
  const uint8_t* pcm = nullptr;
  while (pos + 8 <= size) {
    const uint8_t* chunk = data + pos;
    uint32_t chunk_size;
    std::memcpy(&chunk_size, chunk + 4, 4);
    if (std::memcmp(chunk, "data", 4) == 0) {
      pcm = chunk + 8;
      break;
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (pcm == nullptr) return -2;

  const uint64_t n = frames;
  for (uint64_t f = 0; f < n; ++f) {
    for (int32_t c = 0; c < nch; ++c) {
      const uint64_t i = f * nch + c;
      float v = 0.0f;
      if (format == 3) {  // float32
        std::memcpy(&v, pcm + i * 4, 4);
      } else if (bits == 16) {
        int16_t s;
        std::memcpy(&s, pcm + i * 2, 2);
        v = static_cast<float>(s) / 32768.0f;
      } else if (bits == 24) {
        const uint8_t* b = pcm + i * 3;
        int32_t s = b[0] | (b[1] << 8) | (b[2] << 16);
        if (s >= (1 << 23)) s -= (1 << 24);
        v = static_cast<float>(s) / 8388608.0f;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, pcm + i * 4, 4);
        v = static_cast<float>(s) / 2147483648.0f;
      }
      out[static_cast<uint64_t>(c) * n + f] = v;
    }
  }
  return 0;
}

// Encode planar float32 -> 16-bit PCM WAV. `out` must hold
// 44 + frames*channels*2 bytes. Returns total bytes written.
int64_t neo_wav_encode16(const float* in, int32_t channels, uint64_t frames,
                         int32_t sample_rate, uint8_t* out) {
  const uint32_t data_size = static_cast<uint32_t>(frames * channels * 2);
  const uint32_t riff_size = 36 + data_size;
  uint8_t* p = out;
  std::memcpy(p, "RIFF", 4);
  std::memcpy(p + 4, &riff_size, 4);
  std::memcpy(p + 8, "WAVEfmt ", 8);
  const uint32_t fmt_size = 16;
  std::memcpy(p + 16, &fmt_size, 4);
  const uint16_t fmt_code = 1, nch = static_cast<uint16_t>(channels);
  const uint16_t bits = 16, block_align = nch * 2;
  const uint32_t rate = static_cast<uint32_t>(sample_rate);
  const uint32_t byte_rate = rate * block_align;
  std::memcpy(p + 20, &fmt_code, 2);
  std::memcpy(p + 22, &nch, 2);
  std::memcpy(p + 24, &rate, 4);
  std::memcpy(p + 28, &byte_rate, 4);
  std::memcpy(p + 32, &block_align, 2);
  std::memcpy(p + 34, &bits, 2);
  std::memcpy(p + 36, "data", 4);
  std::memcpy(p + 40, &data_size, 4);
  p += 44;
  for (uint64_t f = 0; f < frames; ++f) {
    for (int32_t c = 0; c < channels; ++c) {
      float v = in[static_cast<uint64_t>(c) * frames + f];
      v = std::max(-1.0f, std::min(1.0f, v));
      const int16_t s = static_cast<int16_t>(std::lrintf(v * 32767.0f));
      std::memcpy(p, &s, 2);
      p += 2;
    }
  }
  return static_cast<int64_t>(44 + data_size);
}

// ------------------------------------------------------------- re-blocker
//
// Buffers arbitrary host block sizes into fixed frames with one frame of
// latency, like the plugin's ConstantOverlapAdd adapter: the host pushes
// N samples and pops N samples each callback; internally whole frames are
// handed to the (Python/JAX) processor when available.

struct NeoReblocker {
  int32_t channels;
  int32_t frame_size;
  std::vector<float> in_fifo;    // planar ring, [channels][capacity]
  std::vector<float> out_fifo;
  int64_t in_count = 0;   // total samples pushed
  int64_t out_count = 0;  // total samples popped
  int64_t in_read = 0;    // frames consumed from in_fifo (samples)
  int64_t out_write = 0;  // samples written to out_fifo
  int64_t capacity;
};

void* neo_reblocker_new(int32_t channels, int32_t frame_size) {
  auto* r = new NeoReblocker();
  r->channels = channels;
  r->frame_size = frame_size;
  r->capacity = static_cast<int64_t>(frame_size) * 8;
  r->in_fifo.assign(static_cast<size_t>(channels) * r->capacity, 0.0f);
  r->out_fifo.assign(static_cast<size_t>(channels) * r->capacity, 0.0f);
  return r;
}

void neo_reblocker_free(void* h) { delete static_cast<NeoReblocker*>(h); }

int32_t neo_reblocker_latency(void* h) {
  return static_cast<NeoReblocker*>(h)->frame_size;
}

// Push planar [channels][n] samples into the input FIFO.
void neo_reblocker_push(void* h, const float* in, int32_t n) {
  auto* r = static_cast<NeoReblocker*>(h);
  for (int32_t c = 0; c < r->channels; ++c) {
    for (int32_t i = 0; i < n; ++i) {
      const int64_t pos = (r->in_count + i) % r->capacity;
      r->in_fifo[static_cast<size_t>(c) * r->capacity + pos] = in[static_cast<int64_t>(c) * n + i];
    }
  }
  r->in_count += n;
}

// Number of full frames ready for processing.
int32_t neo_reblocker_frames_ready(void* h) {
  auto* r = static_cast<NeoReblocker*>(h);
  return static_cast<int32_t>((r->in_count - r->in_read) / r->frame_size);
}

// Pop one full frame (planar [channels][frame_size]) for processing.
int32_t neo_reblocker_pop_frame(void* h, float* frame) {
  auto* r = static_cast<NeoReblocker*>(h);
  if ((r->in_count - r->in_read) < r->frame_size) return -1;
  for (int32_t c = 0; c < r->channels; ++c) {
    for (int32_t i = 0; i < r->frame_size; ++i) {
      const int64_t pos = (r->in_read + i) % r->capacity;
      frame[static_cast<int64_t>(c) * r->frame_size + i] =
          r->in_fifo[static_cast<size_t>(c) * r->capacity + pos];
    }
  }
  r->in_read += r->frame_size;
  return 0;
}

// Push one processed frame into the output FIFO.
void neo_reblocker_push_processed(void* h, const float* frame) {
  auto* r = static_cast<NeoReblocker*>(h);
  for (int32_t c = 0; c < r->channels; ++c) {
    for (int32_t i = 0; i < r->frame_size; ++i) {
      const int64_t pos = (r->out_write + i) % r->capacity;
      r->out_fifo[static_cast<size_t>(c) * r->capacity + pos] =
          frame[static_cast<int64_t>(c) * r->frame_size + i];
    }
  }
  r->out_write += r->frame_size;
}

// Pop planar [channels][n] output samples; zero-fills (latency) when the
// output FIFO hasn't produced enough yet — exactly one frame of latency in
// steady state.
void neo_reblocker_pop(void* h, float* out, int32_t n) {
  auto* r = static_cast<NeoReblocker*>(h);
  for (int32_t c = 0; c < r->channels; ++c) {
    for (int32_t i = 0; i < n; ++i) {
      const int64_t want = r->out_count + i - r->frame_size;  // latency shift
      float v = 0.0f;
      if (want >= 0 && want < r->out_write) {
        const int64_t pos = want % r->capacity;
        v = r->out_fifo[static_cast<size_t>(c) * r->capacity + pos];
      }
      out[static_cast<int64_t>(c) * n + i] = v;
    }
  }
  r->out_count += n;
}

// ------------------------------------------------- lock-free SPSC ring

// Single-producer single-consumer float ring buffer: the host-side
// real-time transport between an audio callback and the compute worker
// (the runtime role a C++ engine would play around the device stream; no
// locks, two atomic cursors, power-of-2 capacity).
struct neo_ring {
  std::vector<float> buf;
  uint64_t mask;
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // written by consumer
};

neo_ring* neo_ring_new(int64_t min_capacity) {
  if (min_capacity <= 0) return nullptr;
  uint64_t cap = 1;
  while (cap < static_cast<uint64_t>(min_capacity)) cap <<= 1;
  auto* r = new neo_ring();
  r->buf.assign(cap, 0.0f);
  r->mask = cap - 1;
  return r;
}

void neo_ring_free(neo_ring* r) { delete r; }

int64_t neo_ring_capacity(const neo_ring* r) {
  return static_cast<int64_t>(r->mask + 1);
}

int64_t neo_ring_readable(const neo_ring* r) {
  return static_cast<int64_t>(r->head.load(std::memory_order_acquire) -
                              r->tail.load(std::memory_order_acquire));
}

int64_t neo_ring_writable(const neo_ring* r) {
  return static_cast<int64_t>(r->mask + 1) - neo_ring_readable(r);
}

// Returns samples actually written (may be < n when full).
int64_t neo_ring_write(neo_ring* r, const float* data, int64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t space = (r->mask + 1) - (head - tail);
  const uint64_t todo = std::min<uint64_t>(n, space);
  for (uint64_t i = 0; i < todo; ++i) {
    r->buf[(head + i) & r->mask] = data[i];
  }
  r->head.store(head + todo, std::memory_order_release);
  return static_cast<int64_t>(todo);
}

// Returns samples actually read (may be < n when empty).
int64_t neo_ring_read(neo_ring* r, float* out, int64_t n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  const uint64_t todo = std::min<uint64_t>(n, avail);
  for (uint64_t i = 0; i < todo; ++i) {
    out[i] = r->buf[(tail + i) & r->mask];
  }
  r->tail.store(tail + todo, std::memory_order_release);
  return static_cast<int64_t>(todo);
}

}  // extern "C"
