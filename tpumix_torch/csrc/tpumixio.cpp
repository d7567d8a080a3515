// tpumixio — native WAV reader and writer of tpumix_torch (a copy of the JAX
// package's native/tpumixio.cpp).
//
// RIFF/WAVE parsing, PCM16/24/32/float32/float64 decoding, stereo->mono
// downmix, and fused decode+downmix+chunk extraction: one pass over the file
// bytes, no intermediate Python objects.  Exposed as a C ABI consumed via
// ctypes (tpumix_torch/data/_native.py); the numpy implementation in
// tpumix_torch/data/wavio.py is the fallback without a compiler.
//
// Build: at first use, by tpumix_torch/ops/_build.py
// (g++ -O3 -march=native -fPIC -shared -Wall -Wextra).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

namespace {

struct WavMeta {
  int32_t samplerate;
  int32_t channels;
  int64_t frames;
  int32_t format;  // 1=PCM16, 2=PCM24, 3=PCM32, 4=FLOAT32, 5=FLOAT64
  int64_t data_offset;
  int32_t bytes_per_frame;
};

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

int parse_header(FILE* f, WavMeta* meta) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return -1;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return -2;

  uint16_t audio_format = 0, channels = 0, bits = 0, block_align = 0;
  uint32_t samplerate = 0;
  int64_t data_offset = -1;
  uint32_t data_size = 0;
  bool have_fmt = false;

  for (;;) {
    unsigned char chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t csize;
    memcpy(&csize, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      uint32_t n = csize < 40 ? csize : 40;
      if (fread(fmt, 1, n, f) != n) return -3;
      if (csize > n && fseek(f, csize - n, SEEK_CUR) != 0) return -3;
      if (csize % 2) fseek(f, 1, SEEK_CUR);
      memcpy(&audio_format, fmt + 0, 2);
      memcpy(&channels, fmt + 2, 2);
      memcpy(&samplerate, fmt + 4, 4);
      memcpy(&block_align, fmt + 12, 2);
      memcpy(&bits, fmt + 14, 2);
      if (audio_format == kExtensible && csize >= 26) {
        memcpy(&audio_format, fmt + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      data_offset = ftell(f);
      data_size = csize;
      if (fseek(f, csize + (csize % 2), SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, csize + (csize % 2), SEEK_CUR) != 0) break;
    }
  }
  if (!have_fmt || data_offset < 0) return -4;

  int fmt_code = 0;
  if (audio_format == kPcm) {
    fmt_code = bits == 16 ? 1 : bits == 24 ? 2 : bits == 32 ? 3 : 0;
  } else if (audio_format == kFloat) {
    fmt_code = bits == 32 ? 4 : bits == 64 ? 5 : 0;
  }
  if (fmt_code == 0 || channels == 0) return -5;

  // The decode loops stride sample_bytes(format) * channels per frame; a
  // malformed block_align smaller than that would size the raw buffer short
  // and overread the heap.  Reject any block_align that disagrees with the
  // format-implied frame size (0 is tolerated: some writers omit it).
  const int32_t implied_bpf = (int32_t)channels * (int32_t)(bits / 8);
  if (block_align != 0 && (int32_t)block_align != implied_bpf) return -6;
  int32_t bpf = implied_bpf;
  // clamp by true file size
  fseek(f, 0, SEEK_END);
  int64_t fsize = ftell(f);
  int64_t avail = fsize - data_offset;
  int64_t dsize = (int64_t)data_size < avail ? (int64_t)data_size : avail;

  meta->samplerate = (int32_t)samplerate;
  meta->channels = channels;
  meta->frames = dsize / bpf;
  meta->format = fmt_code;
  meta->data_offset = data_offset;
  meta->bytes_per_frame = bpf;
  return 0;
}

inline float decode_sample(const unsigned char* p, int fmt) {
  switch (fmt) {
    case 1: {  // PCM16
      int16_t v;
      memcpy(&v, p, 2);
      return (float)v * (1.0f / 32768.0f);
    }
    case 2: {  // PCM24
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      v = (v ^ 0x800000) - 0x800000;
      return (float)v * (1.0f / 8388608.0f);
    }
    case 3: {  // PCM32
      int32_t v;
      memcpy(&v, p, 4);
      return (float)((double)v * (1.0 / 2147483648.0));
    }
    case 4: {  // FLOAT32
      float v;
      memcpy(&v, p, 4);
      return v;
    }
    case 5: {  // FLOAT64
      double v;
      memcpy(&v, p, 8);
      return (float)v;
    }
  }
  return 0.0f;
}

int sample_bytes(int fmt) {
  switch (fmt) {
    case 1: return 2;
    case 2: return 3;
    case 3: return 4;
    case 4: return 4;
    case 5: return 8;
  }
  return 0;
}

}  // namespace

extern "C" {

// Metadata probe.  Returns 0 on success; negative on parse error.
int tpumixio_info(const char* path, int32_t* samplerate, int32_t* channels,
                  int64_t* frames, int32_t* format) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavMeta m;
  int rc = parse_header(f, &m);
  fclose(f);
  if (rc != 0) return rc;
  *samplerate = m.samplerate;
  *channels = m.channels;
  *frames = m.frames;
  *format = m.format;
  return 0;
}

// Decode [start, start+count) frames to interleaved float32 [count, channels].
// Returns frames actually read (clamped), or negative on error.
int64_t tpumixio_read_f32(const char* path, int64_t start, int64_t count,
                          float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavMeta m;
  int rc = parse_header(f, &m);
  if (rc != 0) { fclose(f); return rc; }

  if (start < 0) start = 0;
  if (start > m.frames) start = m.frames;
  if (count < 0 || start + count > m.frames) count = m.frames - start;

  fseek(f, m.data_offset + start * m.bytes_per_frame, SEEK_SET);
  const int sb = sample_bytes(m.format);
  const int64_t total = count * m.channels;
  unsigned char* raw = (unsigned char*)malloc((size_t)(count * m.bytes_per_frame));
  if (!raw) { fclose(f); return -11; }
  size_t got = fread(raw, 1, (size_t)(count * m.bytes_per_frame), f);
  fclose(f);
  int64_t got_frames = (int64_t)(got / m.bytes_per_frame);

  if (m.format == 4 && m.bytes_per_frame == (int32_t)(4 * m.channels)) {
    memcpy(out, raw, (size_t)(got_frames * m.channels * 4));
  } else {
    const unsigned char* p = raw;
    float* o = out;
    for (int64_t i = 0; i < got_frames * m.channels; ++i) {
      *o++ = decode_sample(p, m.format);
      p += sb;
    }
  }
  (void)total;
  free(raw);
  return got_frames;
}

// Fused decode + stereo->mono downmix (channel mean).  out has `count` floats.
int64_t tpumixio_read_mono_f32(const char* path, int64_t start, int64_t count,
                               float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  WavMeta m;
  int rc = parse_header(f, &m);
  if (rc != 0) { fclose(f); return rc; }
  if (start < 0) start = 0;
  if (start > m.frames) start = m.frames;
  if (count < 0 || start + count > m.frames) count = m.frames - start;

  fseek(f, m.data_offset + start * m.bytes_per_frame, SEEK_SET);
  const int sb = sample_bytes(m.format);
  unsigned char* raw = (unsigned char*)malloc((size_t)(count * m.bytes_per_frame));
  if (!raw) { fclose(f); return -11; }
  size_t got = fread(raw, 1, (size_t)(count * m.bytes_per_frame), f);
  fclose(f);
  int64_t got_frames = (int64_t)(got / m.bytes_per_frame);

  const float inv_ch = 1.0f / (float)m.channels;
  const unsigned char* p = raw;
  for (int64_t i = 0; i < got_frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < m.channels; ++c) {
      acc += decode_sample(p, m.format);
      p += sb;
    }
    out[i] = acc * inv_ch;
  }
  free(raw);
  return got_frames;
}

// Fused decode + downmix for a whole song cut into fixed chunks:
// out is [num_chunks, chunk_samples]; short tails are zero-padded.
// Returns the number of chunks written, or negative on error.
int64_t tpumixio_read_chunks_mono_f32(const char* path, int64_t chunk_samples,
                                      int64_t num_chunks, float* out) {
  const int64_t total = chunk_samples * num_chunks;
  int64_t got = tpumixio_read_mono_f32(path, 0, total, out);
  if (got < 0) return got;
  // zero the tail
  for (int64_t i = got; i < total; ++i) out[i] = 0.0f;
  return (got + chunk_samples - 1) / chunk_samples;
}

// Write interleaved float32 [frames, channels] as IEEE-float or PCM16 WAV.
// subtype: 4 = FLOAT32, 1 = PCM16.  Returns 0 on success.
int tpumixio_write(const char* path, const float* data, int64_t frames,
                   int32_t channels, int32_t samplerate, int32_t subtype) {
  FILE* f = fopen(path, "wb");
  if (!f) return -10;
  const int bits = subtype == 1 ? 16 : 32;
  const uint16_t code = subtype == 1 ? kPcm : kFloat;
  const uint16_t block_align = (uint16_t)(channels * bits / 8);
  const uint32_t byte_rate = (uint32_t)samplerate * block_align;
  const uint32_t payload = (uint32_t)(frames * block_align);

  unsigned char head[44];
  memcpy(head, "RIFF", 4);
  uint32_t riff_size = 36 + payload;
  memcpy(head + 4, &riff_size, 4);
  memcpy(head + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(head + 16, &fmt_size, 4);
  uint16_t ch16 = (uint16_t)channels, bits16 = (uint16_t)bits;
  memcpy(head + 20, &code, 2);
  memcpy(head + 22, &ch16, 2);
  uint32_t sr = (uint32_t)samplerate;
  memcpy(head + 24, &sr, 4);
  memcpy(head + 28, &byte_rate, 4);
  memcpy(head + 32, &block_align, 2);
  memcpy(head + 34, &bits16, 2);
  memcpy(head + 36, "data", 4);
  memcpy(head + 40, &payload, 4);
  fwrite(head, 1, 44, f);

  const int64_t n = frames * channels;
  if (subtype == 1) {
    const int64_t kBuf = 1 << 16;
    int16_t* buf = (int16_t*)malloc(kBuf * sizeof(int16_t));
    for (int64_t lo = 0; lo < n; lo += kBuf) {
      int64_t m = n - lo < kBuf ? n - lo : kBuf;
      for (int64_t i = 0; i < m; ++i) {
        float v = data[lo + i] * 32768.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        buf[i] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
      }
      fwrite(buf, sizeof(int16_t), (size_t)m, f);
    }
    free(buf);
  } else {
    fwrite(data, sizeof(float), (size_t)n, f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
