// Native stream-IO runtime for the receive chain.
//
// Role: the host-side data plane the reference implements in C
// (pmdemod.c:204-230 fread loops, symdemod.c:101-126 sliding buffer,
// decode.c:149-161 refill) — reading little-endian int16 IQ byte
// streams, deinterleaving/converting them into device-feedable planar
// float buffers, and keeping a lock-protected ring buffer filled from a
// file descriptor by a background thread so Python never blocks on IO
// between device steps.
//
// Exposed as a plain C ABI consumed via ctypes
// (isee3_decoder_tpu/utils/native.py); NumPy fallbacks exist for every
// entry point.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Conversion kernels
// ---------------------------------------------------------------------------

// Interleaved little-endian int16 I,Q -> planar float32 (optionally
// swapped, the -f spectrum flip of pmdemod.c:218-230).
void iq_deinterleave(const int16_t* in, int64_t nsamples, float* out_i,
                     float* out_q, int flip) {
  if (!flip) {
    for (int64_t n = 0; n < nsamples; ++n) {
      out_i[n] = static_cast<float>(in[2 * n]);
      out_q[n] = static_cast<float>(in[2 * n + 1]);
    }
  } else {
    for (int64_t n = 0; n < nsamples; ++n) {
      out_i[n] = static_cast<float>(in[2 * n + 1]);
      out_q[n] = static_cast<float>(in[2 * n]);
    }
  }
}

// int16 baseband -> int32 widening (symdemod input conditioning).
void widen_i16_i32(const int16_t* in, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = in[i];
}

// float32 -> int16 with C truncation-toward-zero semantics
// (pmdemod.c:366 output cast).
void narrow_f32_i16_trunc(const float* in, int64_t n, int16_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = static_cast<int16_t>(in[i]);
}

// Offset-binary soft symbols -> centered int32 (decode.c:174 sym - 128).
void center_u8_i32(const uint8_t* in, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = static_cast<int32_t>(in[i]) - 128;
}

// ---------------------------------------------------------------------------
// Ring-buffer stream reader
// ---------------------------------------------------------------------------

struct StreamReader {
  int fd = -1;
  std::vector<uint8_t> ring;
  int64_t head = 0;  // write position (total bytes read)
  int64_t tail = 0;  // read position (total bytes consumed)
  bool eof = false;
  bool stop_requested = false;
  std::mutex mu;
  std::condition_variable cv_data;   // signalled when data arrives
  std::condition_variable cv_space;  // signalled when space frees
  std::thread worker;

  explicit StreamReader(int fd_, int64_t capacity)
      : fd(fd_), ring(static_cast<size_t>(capacity)) {}

  int64_t capacity() const { return static_cast<int64_t>(ring.size()); }

  void run() {
    std::vector<uint8_t> chunk(1 << 20);
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop_requested || head - tail < capacity();
        });
        if (stop_requested) return;
      }
      int64_t space;
      {
        std::lock_guard<std::mutex> lk(mu);
        space = capacity() - (head - tail);
      }
      int64_t want = std::min<int64_t>(space, (int64_t)chunk.size());
      ssize_t got = read(fd, chunk.data(), static_cast<size_t>(want));
      std::lock_guard<std::mutex> lk(mu);
      if (got <= 0) {
        eof = true;
        cv_data.notify_all();
        return;
      }
      for (ssize_t i = 0; i < got; ++i)
        ring[static_cast<size_t>((head + i) % capacity())] = chunk[i];
      head += got;
      cv_data.notify_all();
    }
  }
};

void* stream_reader_create(int fd, int64_t capacity) {
  auto* r = new StreamReader(fd, capacity);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Blocking read of exactly nbytes (short at EOF). Returns bytes copied.
int64_t stream_reader_read(void* handle, uint8_t* out, int64_t nbytes) {
  auto* r = static_cast<StreamReader*>(handle);
  int64_t copied = 0;
  while (copied < nbytes) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_data.wait(lk, [&] { return r->eof || r->head > r->tail; });
    int64_t avail = r->head - r->tail;
    if (avail == 0 && r->eof) break;
    int64_t take = std::min(avail, nbytes - copied);
    for (int64_t i = 0; i < take; ++i)
      out[copied + i] =
          r->ring[static_cast<size_t>((r->tail + i) % r->capacity())];
    r->tail += take;
    copied += take;
    r->cv_space.notify_all();
  }
  return copied;
}

int64_t stream_reader_available(void* handle) {
  auto* r = static_cast<StreamReader*>(handle);
  std::lock_guard<std::mutex> lk(r->mu);
  return r->head - r->tail;
}

int stream_reader_eof(void* handle) {
  auto* r = static_cast<StreamReader*>(handle);
  std::lock_guard<std::mutex> lk(r->mu);
  return r->eof && r->head == r->tail;
}

void stream_reader_destroy(void* handle) {
  auto* r = static_cast<StreamReader*>(handle);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop_requested = true;
  }
  r->cv_space.notify_all();
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

// ---------------------------------------------------------------------------
// Host-side reference codec kernels (golden oracles / CPU fast path)
// ---------------------------------------------------------------------------

// Convolutional encode, MSB-first, rate 1/2 (semantics of encode.c:17-35,
// fresh implementation). Returns the final K-bit encoder state.
uint64_t conv_encode(const uint8_t* data, int64_t nbytes, uint8_t* symbols,
                     uint64_t poly1, uint64_t poly2, int k, int g1flip,
                     int g2flip, uint64_t state) {
  int64_t out = 0;
  for (int64_t b = 0; b < nbytes; ++b) {
    for (int bit = 7; bit >= 0; --bit) {
      state = (state << 1) | ((data[b] >> bit) & 1u);
      symbols[out++] =
          static_cast<uint8_t>(g1flip ^ __builtin_parityll(state & poly1));
      symbols[out++] =
          static_cast<uint8_t>(g2flip ^ __builtin_parityll(state & poly2));
    }
  }
  return state & ((k >= 64) ? ~0ULL : ((1ULL << k) - 1));
}

// Viterbi decode of one frame, int32 metrics, SSE2-compatible
// tie-breaking (decision bit 1 when the 1-branch strictly wins).
// An independent host oracle with the same observable behavior as the
// reference kernels (viterbi224.h API); allocates transiently.
int viterbi_decode_frame(const uint8_t* syms, int nbits, uint32_t start_state,
                         uint32_t end_state, uint64_t poly1, uint64_t poly2,
                         int k, int g1flip, int g2flip, uint8_t* out_bits) {
  const int64_t nstates = 1LL << (k - 1);
  const int64_t half = nstates / 2;
  std::vector<int32_t> oldm(nstates), newm(nstates);
  std::vector<uint8_t> b0(half), b1(half);
  for (int64_t i = 0; i < half; ++i) {
    b0[i] = g1flip ^ __builtin_parityll((2 * i) & poly1);
    b1[i] = g2flip ^ __builtin_parityll((2 * i) & poly2);
  }
  const int32_t bias = 5000;
  std::fill(oldm.begin(), oldm.end(), bias);
  oldm[start_state & (nstates - 1)] = 0;

  std::vector<uint8_t> decisions(static_cast<size_t>(nbits) * nstates);
  for (int t = 0; t < nbits; ++t) {
    int32_t s0 = syms[2 * t], s1 = syms[2 * t + 1];
    uint8_t* dec = &decisions[static_cast<size_t>(t) * nstates];
    int32_t mn = INT32_MAX;
    for (int64_t i = 0; i < half; ++i) {
      int32_t m = (b0[i] ? 255 - s0 : s0) + (b1[i] ? 255 - s1 : s1);
      int32_t mm = 510 - m;
      int32_t m0 = oldm[i] + m;
      int32_t m1 = oldm[i + half] + mm;
      int32_t m2 = oldm[i] + mm;
      int32_t m3 = oldm[i + half] + m;
      uint8_t d0 = m0 > m1;
      uint8_t d1 = m2 > m3;
      int32_t s0v = d0 ? m1 : m0;
      int32_t s1v = d1 ? m3 : m2;
      newm[2 * i] = s0v;
      newm[2 * i + 1] = s1v;
      dec[2 * i] = d0;
      dec[2 * i + 1] = d1;
      mn = std::min(mn, std::min(s0v, s1v));
    }
    for (int64_t s = 0; s < nstates; ++s) newm[s] -= mn;
    oldm.swap(newm);
  }
  uint32_t state = end_state & (nstates - 1);
  for (int t = nbits - 1; t >= 0; --t) {
    out_bits[t] = state & 1;
    uint8_t bit = decisions[static_cast<size_t>(t) * nstates + state];
    state = (static_cast<uint32_t>(bit) << (k - 2)) | (state >> 1);
  }
  return 0;
}

}  // extern "C"
