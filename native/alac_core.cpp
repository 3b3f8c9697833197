// Native (C++) ALAC packet decode core.
//
// Host-side runtime companion to the device pipeline: the single-packet fast
// path behind PacketDecoder, the scalar fallback for malformed packets, and
// an OpenMP-threaded batch decoder for host-only deployment.  Independent
// implementation of the same math as saprobe_alac_tpu/codec (adaptive
// Golomb-Rice entropy coding + adaptive LPC + stereo un-decorrelation),
// with Go fixed-width semantics (wrapping int32, saturating shift counts)
// for bit-exact agreement with the Python oracle and the device path.
//
// Behavioral parity references (reference repo, decode math only):
//   golomb.go:112-253, predictor.go:45-684, matrix.go, decoder.go:133-574.
//
// C ABI only; bound from Python via ctypes (saprobe_alac_tpu/native).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// ---------- error codes (mirror ops/walk.py) ----------
enum ErrCode : int32_t {
  ERR_NONE = 0,
  ERR_OVERRUN = 1,
  ERR_ELEMENT = 2,
  ERR_HEADER = 3,
  ERR_SHIFT = 4,
  ERR_SAMPLES = 5,
  ERR_BAD_DEPTH = 8,
  ERR_OUTPUT_CAP = 9,
};

// ---------- Go fixed-width helpers ----------
static inline uint32_t shl32(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x << s; }
static inline uint32_t ushr32(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x >> s; }
static inline int32_t sshr32(int32_t x, uint32_t s) {
  if (s >= 32) return x < 0 ? -1 : 0;
  return x >> s;  // arithmetic on all sane compilers; verified by tests
}
static inline int32_t sext_bits(int32_t x, uint32_t bits) {
  uint32_t cs = 32u - bits;  // wraps hugely for bits > 32, like Go uint32
  return sshr32(static_cast<int32_t>(shl32(static_cast<uint32_t>(x), cs)), cs);
}
static inline int32_t lead_zeros(uint32_t x) {
  return x == 0 ? 32 : __builtin_clz(x);
}
static inline int32_t lg3a(uint32_t x) { return 31 - lead_zeros(x + 3u); }

// ---------- bit cursor over a zero-padded packet copy ----------
struct Cursor {
  const uint8_t* data;  // padded: size + >=8 zero bytes
  int64_t size_bits;
  int64_t pad_bytes;  // total buffer length incl. zero pad

  int64_t pos = 0;

  // Clamp a byte offset so 5-byte window loads stay in the padded buffer.
  // Reads steered into the pad see zeros; reads clamped from beyond return
  // pad zeros too, and the decode loops' overrun checks surface the error.
  int64_t clamp(int64_t byteoff) const {
    if (byteoff < 0) return 0;
    int64_t m = pad_bytes - 5;
    return byteoff > m ? m : byteoff;
  }

  // True 32 stream bits at an absolute bit position.
  uint32_t window32(int64_t bitpos) const {
    int64_t byteoff = clamp(bitpos >> 3);
    uint32_t sh = static_cast<uint32_t>(bitpos & 7);
    uint64_t w = (static_cast<uint64_t>(data[byteoff]) << 32) |
                 (static_cast<uint64_t>(data[byteoff + 1]) << 24) |
                 (static_cast<uint64_t>(data[byteoff + 2]) << 16) |
                 (static_cast<uint64_t>(data[byteoff + 3]) << 8) |
                 static_cast<uint64_t>(data[byteoff + 4]);
    return static_cast<uint32_t>(w >> (8 - sh));
  }

  uint32_t read(uint32_t nbits) {
    uint32_t v = nbits < 32 ? window32(pos) >> (32 - nbits) : window32(pos);
    pos += nbits;
    return v;
  }
  void advance(int64_t n) { pos += n; }
  void byte_align() { pos = (pos + 7) & ~7ll; }
  bool past_end() const { return (pos >> 3) >= (size_bits >> 3); }
};

// getStreamBits with the Go numbits==33 corner (golomb.go:86-108).
static inline uint32_t get_stream_bits(const Cursor& c, int64_t bitpos, uint32_t nbits) {
  if (nbits <= 32) {
    uint32_t w = c.window32(bitpos);
    return nbits < 32 ? w >> (32 - nbits) : w;
  }
  // nbits == 33: Go's saturating shifts zero the high part; only the low
  // (bitpos&7)+1 bits of the 5th byte survive.
  int64_t byteoff = c.clamp(bitpos >> 3);
  uint32_t b = static_cast<uint32_t>(bitpos & 7);
  return static_cast<uint32_t>(c.data[byteoff + 4]) >> (7 - b);
}

// ---------- adaptive Golomb-Rice (golomb.go:112-253) ----------
struct AgState {
  uint32_t mb0, pb, kb, wb;
};

static int32_t dyn_decomp(const AgState& ag, Cursor& cur, int32_t* out,
                          int32_t num_samples, uint32_t max_size) {
  uint32_t mean = ag.mb0;
  int32_t zmode = 0;
  int32_t count = 0;
  const uint32_t pb = ag.pb, kb = ag.kb, wb = ag.wb;
  int64_t bitpos = cur.pos;
  const int64_t max_bits = cur.size_bits;

  while (count < num_samples) {
    if (bitpos >= max_bits || bitpos < 0) return ERR_OVERRUN;

    uint32_t m = mean >> 9;
    uint32_t k = static_cast<uint32_t>(lg3a(m));
    if (k > kb) k = kb;
    m = shl32(1, k) - 1;

    uint32_t win = cur.window32(bitpos);
    uint32_t value = static_cast<uint32_t>(lead_zeros(~win));

    if (value >= 9) {
      value = get_stream_bits(cur, bitpos + 9, max_size);
      bitpos += 9 + max_size;
    } else {
      bitpos += value + 1;
      if (k != 1) {
        uint32_t win2 = shl32(win, value + 1);
        uint32_t v = ushr32(win2, 32 - k);
        if (v >= 2) {
          value = value * m + v - 1;
          bitpos += k;
        } else {
          value = value * m;
          bitpos += static_cast<int64_t>(k) - 1;  // k==0 would underflow in Go
          if (k == 0 && bitpos < 0) return ERR_OVERRUN;
        }
      }
    }

    uint32_t nd = value + static_cast<uint32_t>(zmode);
    int32_t mult = (nd & 1) ? -1 : 1;
    out[count++] = static_cast<int32_t>((nd + 1) >> 1) * mult;

    mean = pb * nd + mean - ((pb * mean) >> 9);
    if (value > 0xFFFFu) mean = 0xFFFFu;
    zmode = 0;

    if ((mean << 2) < 512u && count < num_samples) {
      zmode = 1;
      int32_t k32 = lead_zeros(mean) - 24 + static_cast<int32_t>((mean + 16) >> 6);
      if (k32 < 0) k32 = 0;
      uint32_t mz = (shl32(1, static_cast<uint32_t>(k32)) - 1) & wb;

      uint32_t zwin = cur.window32(bitpos);
      uint32_t zpre = static_cast<uint32_t>(lead_zeros(~zwin));
      uint32_t run;
      if (zpre >= 9) {
        run = ushr32(shl32(zwin, 9), 16);
        bitpos += 9 + 16;
      } else {
        bitpos += zpre + 1;
        uint32_t zv = k32 > 0 ? ushr32(shl32(zwin, zpre + 1), 32 - k32) : 0;
        if (zv >= 2) {
          run = zpre * mz + zv - 1;
          bitpos += k32;
        } else {
          run = zpre * mz;
          bitpos += k32 - 1;
        }
      }

      if (count + static_cast<int64_t>(run) > num_samples) return ERR_SAMPLES;
      std::memset(out + count, 0, run * sizeof(int32_t));
      count += run;
      zmode = (run >= 65535u) ? 0 : 1;
      mean = 0;
    }
  }

  cur.pos = bitpos;
  return ERR_NONE;
}

// ---------- adaptive LPC reconstruction (predictor.go:45-684) ----------
// Unified generic loop with the per-order int16-wrap distinction:
// orders 4/5/6/8 keep int32 coef accumulation; others wrap per step.
static void reconstruct(const int32_t* res, int32_t* out, int32_t num,
                        const int16_t* coefs_in, int32_t order,
                        uint32_t chan_bits, uint32_t den_shift) {
  if (num <= 0) return;
  out[0] = res[0];
  if (order == 0) {
    if (res != out) std::memcpy(out + 1, res + 1, (num - 1) * sizeof(int32_t));
    return;
  }
  if (order == 31) {
    int32_t prev = out[0];
    for (int32_t i = 1; i < num; ++i) {
      prev = sext_bits(res[i] + prev, chan_bits);
      out[i] = prev;
    }
    return;
  }

  for (int32_t i = 1; i <= order && i < num; ++i)
    out[i] = sext_bits(res[i] + out[i - 1], chan_bits);

  const bool wrap16 = !(order == 4 || order == 5 || order == 6 || order == 8);
  const int32_t den_half = den_shift > 0 ? 1 << (den_shift - 1) : 0;
  int32_t c[32];
  for (int32_t k = 0; k < order; ++k) c[k] = coefs_in[k];

  for (int32_t idx = order + 1; idx < num; ++idx) {
    const int32_t top = out[idx - 1 - order];

    int32_t acc = 0;
    for (int32_t k = 0; k < order; ++k)
      acc += c[k] * (out[idx - 1 - k] - top);  // wrapping int32
    const int32_t sum1 = sshr32(acc + den_half, den_shift);

    const int32_t del = res[idx];
    out[idx] = sext_bits(del + top + sum1, chan_bits);
    if (del == 0) continue;
    const int32_t sign = del > 0 ? 1 : -1;

    int32_t del0 = del;
    for (int32_t j = 1; j <= order; ++j) {
      const int32_t k = order - j;
      const int32_t dd = top - out[idx - 1 - k];
      const int32_t sgn = (dd > 0 ? 1 : dd < 0 ? -1 : 0) * sign;
      int32_t nc = c[k] - sgn;
      c[k] = wrap16 ? static_cast<int16_t>(nc) : nc;
      del0 -= j * sshr32(sgn * dd, den_shift);
      if (sign > 0 ? del0 <= 0 : del0 >= 0) break;
    }
  }
}

// ---------- per-packet decode ----------
struct Config {
  uint32_t frame_length;
  uint32_t bit_depth;
  uint32_t num_channels;
  uint32_t pb, mb, kb;
  uint32_t max_run;
};

// MPEG element order -> SMPTE interleave order (decoder.go:55-64).
static const int kLayout[8][8] = {
    {0}, {0, 1}, {2, 0, 1}, {2, 0, 1, 3}, {2, 0, 1, 3, 4},
    {2, 0, 1, 4, 5, 3}, {2, 0, 1, 4, 5, 6, 3}, {2, 6, 7, 0, 1, 4, 5, 3}};

struct Scratch {
  std::vector<uint8_t> padded;
  std::vector<int32_t> res, u, v;
  std::vector<uint16_t> shift;
  // Set by decode_channels for the caller's write_channel pass.
  int shift_stride_ = 1;
  int bytes_shifted_ = 0;
};

static inline int bytes_per_sample(uint32_t depth) {
  switch (depth) {
    case 16: return 2;
    case 20: case 24: return 3;
    case 32: return 4;
    default: return 0;
  }
}

static void write_channel(uint8_t* out, const int32_t* vals,
                          const uint16_t* shift_vals, int shift_stride,
                          int bytes_shifted, int32_t n, int out_chan,
                          int num_chan, uint32_t depth) {
  // Only the 24/32-bit writers re-insert shift bits (matrix.go:220-301);
  // the 16/20-bit writers ignore bytesShifted.
  if (depth < 24) bytes_shifted = 0;
  const int bps = bytes_per_sample(depth);
  const int stride = num_chan * bps;
  uint8_t* p = out + out_chan * bps;
  const uint32_t shift = bytes_shifted * 8;
  for (int32_t i = 0; i < n; ++i, p += stride) {
    int32_t v = vals[i];
    if (bytes_shifted) v = static_cast<int32_t>(shl32(v, shift)) | shift_vals[i * shift_stride];
    if (depth == 20) v = static_cast<int32_t>(shl32(v, 4));
    p[0] = static_cast<uint8_t>(v);
    p[1] = static_cast<uint8_t>(v >> 8);
    if (bps >= 3) p[2] = static_cast<uint8_t>(v >> 16);
    if (bps == 4) p[3] = static_cast<uint8_t>(v >> 24);
  }
}

static int32_t decode_channels(const Config& cfg, Cursor& cur, Scratch& s,
                               bool pair, uint32_t& num_samples,
                               uint8_t* out) {
  // Common SCE/CPE header (decoder.go:210-235 / 348-375).
  cur.read(4);  // element instance tag
  if (cur.read(12) != 0) return ERR_HEADER;
  uint32_t hdr = cur.read(4);
  uint32_t partial = hdr >> 3;
  int bytes_shifted = static_cast<int>((hdr >> 1) & 3);
  if (bytes_shifted == 3) return ERR_SHIFT;
  uint32_t escape = hdr & 1;
  uint32_t chan_bits = cfg.bit_depth - bytes_shifted * 8 + (pair ? 1 : 0);

  if (partial) {
    num_samples = (cur.read(16) << 16) | cur.read(16);
    if (num_samples > cfg.frame_length) return ERR_SAMPLES;
  }
  const int32_t ns = static_cast<int32_t>(num_samples);

  int32_t mix_bits = 0, mix_res = 0;

  if (!escape) {
    mix_bits = static_cast<int32_t>(cur.read(8));
    mix_res = static_cast<int32_t>(static_cast<int8_t>(cur.read(8)));
    if (!pair) { mix_bits = 0; mix_res = 0; }

    struct Ch { uint32_t mode, den, pbf; int32_t order; int16_t coefs[32]; };
    Ch ch[2];
    const int nch = pair ? 2 : 1;
    for (int c = 0; c < nch; ++c) {
      uint32_t b = cur.read(8);
      ch[c].mode = b >> 4;
      ch[c].den = b & 15;
      b = cur.read(8);
      ch[c].pbf = b >> 5;
      ch[c].order = static_cast<int32_t>(b & 31);
      for (int32_t k = 0; k < ch[c].order; ++k)
        ch[c].coefs[k] = static_cast<int16_t>(cur.read(16));
    }

    Cursor shift_cur = cur;
    if (bytes_shifted) cur.advance(static_cast<int64_t>(bytes_shifted) * 8 * nch * ns);

    for (int c = 0; c < nch; ++c) {
      AgState ag{cfg.mb, (cfg.pb * ch[c].pbf) / 4, cfg.kb,
                 cfg.kb < 32 ? shl32(1, cfg.kb) - 1 : 0xFFFFFFFFu};
      int32_t rc = dyn_decomp(ag, cur, s.res.data(), ns, chan_bits);
      if (rc != ERR_NONE) return rc;
      if (ch[c].mode != 0)
        reconstruct(s.res.data(), s.res.data(), ns, nullptr, 31, chan_bits, 0);
      reconstruct(s.res.data(), (c == 0 ? s.u : s.v).data(), ns, ch[c].coefs,
                  ch[c].order, chan_bits, ch[c].den);
    }

    if (bytes_shifted) {
      const uint32_t w = bytes_shifted * 8;
      for (int32_t i = 0; i < ns * nch; ++i)
        s.shift[i] = static_cast<uint16_t>(shift_cur.read(w));
    }
  } else {
    if (pair) chan_bits = cfg.bit_depth;  // escape reset (decoder.go:388)
    // Pre-check the whole raw region (the reference reads sample-by-sample
    // and crashes past the buffer; we error instead).
    const int64_t needed = static_cast<int64_t>(chan_bits) * ns * (pair ? 2 : 1);
    if (cur.pos + needed > cur.size_bits) return ERR_OVERRUN;
    for (int32_t i = 0; i < ns; ++i) {
      s.u[i] = sext_bits(static_cast<int32_t>(cur.read(chan_bits)), chan_bits);
      if (pair) s.v[i] = sext_bits(static_cast<int32_t>(cur.read(chan_bits)), chan_bits);
    }
    bytes_shifted = 0;
  }

  // Stereo un-decorrelation (matrix.go:38-49).
  if (pair && mix_res != 0) {
    for (int32_t i = 0; i < ns; ++i) {
      int32_t left = s.u[i] + s.v[i] - sshr32(mix_res * s.v[i], mix_bits);
      int32_t right = left - s.v[i];
      s.u[i] = left;
      s.v[i] = right;
    }
  }

  (void)out;
  // caller writes channels (needs chan index); stash shift params via struct:
  s.shift_stride_ = pair ? 2 : 1;
  s.bytes_shifted_ = bytes_shifted;
  return ERR_NONE;
}

}  // namespace

extern "C" {

struct AlacConfigC {
  uint32_t frame_length;
  uint32_t bit_depth;
  uint32_t num_channels;
  uint32_t pb, mb, kb;
  uint32_t max_run;
};

// Decode one packet to interleaved LE PCM.  Returns ERR_* code.
// out_len receives the byte count (num_samples * channels * bps).
int32_t alac_decode_packet(const AlacConfigC* ccfg, const uint8_t* packet,
                           int32_t packet_len, uint8_t* out, int64_t out_cap,
                           int32_t* out_len);

// Threaded batch decode: packets concatenated in `flat` with offsets/sizes.
// Each output row is at out + i*out_stride.  errs[i] gets the ERR_* code,
// out_lens[i] the byte count.  Returns number of failed packets.
int32_t alac_decode_batch(const AlacConfigC* ccfg, const uint8_t* flat,
                          const int64_t* offsets, const int32_t* sizes,
                          int32_t count, uint8_t* out, int64_t out_stride,
                          int32_t* out_lens, int32_t* errs, int32_t n_threads);

int32_t alac_core_version(void);
}

namespace {

int32_t decode_packet_impl(const Config& cfg, const uint8_t* packet,
                           int32_t packet_len, uint8_t* out, int64_t out_cap,
                           int32_t* out_len, Scratch& s) {
  const int bps = bytes_per_sample(cfg.bit_depth);
  if (bps == 0 || cfg.num_channels < 1 || cfg.num_channels > 8) return ERR_BAD_DEPTH;

  const int64_t full = static_cast<int64_t>(cfg.frame_length) * cfg.num_channels * bps;
  if (out_cap < full) return ERR_OUTPUT_CAP;
  std::memset(out, 0, full);

  const uint32_t F = cfg.frame_length;
  s.padded.resize(packet_len + 8);
  std::memcpy(s.padded.data(), packet, packet_len);
  std::memset(s.padded.data() + packet_len, 0, 8);
  s.res.resize(F);
  s.u.resize(F);
  s.v.resize(F);
  s.shift.resize(2 * F);

  Cursor cur{s.padded.data(), static_cast<int64_t>(packet_len) * 8,
             static_cast<int64_t>(s.padded.size())};

  uint32_t num_samples = F;
  uint32_t chan = 0;
  const int* layout = kLayout[cfg.num_channels - 1];

  while (true) {
    if (cur.past_end()) return ERR_OVERRUN;
    uint32_t tag = cur.read(3);

    if (tag == 0 || tag == 3) {  // SCE / LFE
      int32_t rc = decode_channels(cfg, cur, s, false, num_samples, out);
      if (rc != ERR_NONE) return rc;
      write_channel(out, s.u.data(), s.shift.data(), 1, s.bytes_shifted_,
                    num_samples, layout[chan], cfg.num_channels, cfg.bit_depth);
      chan += 1;
    } else if (tag == 1) {  // CPE
      if (chan + 2 > cfg.num_channels) break;
      int32_t rc = decode_channels(cfg, cur, s, true, num_samples, out);
      if (rc != ERR_NONE) return rc;
      write_channel(out, s.u.data(), s.shift.data(), 2, s.bytes_shifted_,
                    num_samples, layout[chan], cfg.num_channels, cfg.bit_depth);
      write_channel(out, s.v.data(), s.shift.data() + 1, 2, s.bytes_shifted_,
                    num_samples, layout[chan] + 1, cfg.num_channels, cfg.bit_depth);
      chan += 2;
    } else if (tag == 2 || tag == 5) {  // CCE / PCE
      return ERR_ELEMENT;
    } else if (tag == 4) {  // DSE (decoder.go:554-574)
      cur.read(4);
      uint32_t align = cur.read(1);
      uint32_t cnt = cur.read(8);
      if (cnt == 255) cnt += cur.read(8);
      if (align) cur.byte_align();
      cur.advance(static_cast<int64_t>(cnt) * 8);
      if (cur.past_end()) return ERR_OVERRUN;
    } else if (tag == 6) {  // FIL (decoder.go:538-551)
      int32_t cnt = static_cast<int32_t>(cur.read(4));
      if (cnt == 15) cnt += static_cast<int32_t>(cur.read(8)) - 1;
      cur.advance(static_cast<int64_t>(cnt) * 8);
      if (cur.past_end()) return ERR_OVERRUN;
    } else {  // END
      cur.byte_align();
      break;
    }

    if (chan >= cfg.num_channels) break;
  }

  *out_len = static_cast<int32_t>(num_samples) * cfg.num_channels * bps;
  return ERR_NONE;
}

}  // namespace

extern "C" {

int32_t alac_decode_packet(const AlacConfigC* ccfg, const uint8_t* packet,
                           int32_t packet_len, uint8_t* out, int64_t out_cap,
                           int32_t* out_len) {
  Config cfg{ccfg->frame_length, ccfg->bit_depth, ccfg->num_channels,
             ccfg->pb, ccfg->mb, ccfg->kb, ccfg->max_run};
  Scratch s;
  return decode_packet_impl(cfg, packet, packet_len, out, out_cap, out_len, s);
}

int32_t alac_decode_batch(const AlacConfigC* ccfg, const uint8_t* flat,
                          const int64_t* offsets, const int32_t* sizes,
                          int32_t count, uint8_t* out, int64_t out_stride,
                          int32_t* out_lens, int32_t* errs, int32_t n_threads) {
  Config cfg{ccfg->frame_length, ccfg->bit_depth, ccfg->num_channels,
             ccfg->pb, ccfg->mb, ccfg->kb, ccfg->max_run};
  int32_t failures = 0;
#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel reduction(+ : failures)
  {
    Scratch s;
#pragma omp for schedule(dynamic, 8)
    for (int32_t i = 0; i < count; ++i) {
      errs[i] = decode_packet_impl(cfg, flat + offsets[i], sizes[i],
                                   out + i * out_stride, out_stride, &out_lens[i], s);
      if (errs[i] != ERR_NONE) ++failures;
    }
  }
#else
  Scratch s;
  for (int32_t i = 0; i < count; ++i) {
    errs[i] = decode_packet_impl(cfg, flat + offsets[i], sizes[i],
                                 out + i * out_stride, out_stride, &out_lens[i], s);
    if (errs[i] != ERR_NONE) ++failures;
  }
#endif
  return failures;
}

// Host-side packet batching for the device pipeline: packets (concatenated
// in `flat` with offsets/sizes) -> (B, W_words) array of big-endian-bit-order
// words, zero-padded (bitbuffer.go:28-32 pad semantics; the device path's
// guard words are included in W_words by the caller).  The Python/numpy
// version costs ~240 ms for a 2048x12KB batch (per-packet interpreter
// overhead); this is the IO-path analogue of the reference's zero-copy
// buffer handling.
int32_t alac_pack_packets(const uint8_t* flat, const int64_t* offsets,
                          const int32_t* sizes, int32_t count,
                          int32_t w_words, uint32_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int32_t i = 0; i < count; ++i) {
    const uint8_t* src = flat + offsets[i];
    const int32_t len = sizes[i];
    uint32_t* row = out + static_cast<int64_t>(i) * w_words;
    const int32_t full = len / 4;
    int32_t w = 0;
    for (; w < full; ++w) {
      const uint8_t* p = src + w * 4;
      row[w] = (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
               (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
    }
    if (len & 3) {
      uint32_t acc = 0;
      for (int32_t b = 0; b < (len & 3); ++b)
        acc |= static_cast<uint32_t>(src[full * 4 + b]) << (24 - 8 * b);
      row[w++] = acc;
    }
    for (; w < w_words; ++w) row[w] = 0;
  }
  return 0;
}

int32_t alac_core_version(void) { return 1; }
}
