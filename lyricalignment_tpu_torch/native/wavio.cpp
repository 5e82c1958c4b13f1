// Native data-loader core: WAV decode + polyphase resampling.
//
// The reference's audio IO runs through librosa -> libsndfile (C)
// (`utils/audio.py:3-20`); this is the framework's own native equivalent,
// exposed to Python via ctypes (lyricalignment_tpu_torch/data/native_loader.py).
// The hot loops (PCM conversion, channel mixdown, FIR polyphase resampling)
// run without the GIL, so the threaded batch loader gets real parallelism.
//
// Build: g++ -O3 -march=native -shared -fPIC wavio.cpp -o libwavio.so
//
// API (C linkage, plain buffers — no Python dependency):
//   wav_info(path, *sr, *channels, *frames)            -> 0 on success
//   wav_decode(path, out, max_frames, audio_type)      -> frames written
//       audio_type: 0 = mono mixdown, 1 = (ch0+ch1)/2, 2 = ch1 only
//   resample_poly(in, n_in, out, n_out_cap, taps, n_taps, up, down)
//       -> samples written; `taps` = FIR prototype designed host-side
//          (scipy.signal.firwin kaiser), applied as an efficient polyphase.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <algorithm>

extern "C" {

namespace {

struct WavHeader {
    uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
    uint16_t channels = 0;
    uint32_t sample_rate = 0;
    uint16_t bits = 0;
    long data_offset = -1;
    uint32_t data_bytes = 0;
};

bool read_header(FILE* f, WavHeader* h) {
    char riff[4], wave[4];
    uint32_t riff_size;
    // File size up front: declared chunk sizes are untrusted and must be
    // clamped to what is actually present (truncated/corrupt files).
    long fsize = -1;
    if (fseek(f, 0, SEEK_END) == 0) fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (fsize < 0) return false;
    if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return false;
    if (fread(&riff_size, 4, 1, f) != 1) return false;
    if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return false;

    // walk chunks
    for (;;) {
        char id[4];
        uint32_t size;
        if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
        if (memcmp(id, "fmt ", 4) == 0) {
            uint16_t fmt, ch;
            uint32_t sr, byte_rate;
            uint16_t block, bits;
            if (size < 16) return false;
            // Short reads (file truncated inside the fmt payload) must fail
            // the parse, never leave these stack fields uninitialized.
            if (fread(&fmt, 2, 1, f) != 1 ||
                fread(&ch, 2, 1, f) != 1 ||
                fread(&sr, 4, 1, f) != 1 ||
                fread(&byte_rate, 4, 1, f) != 1 ||
                fread(&block, 2, 1, f) != 1 ||
                fread(&bits, 2, 1, f) != 1) return false;
            if (fmt == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
                uint16_t ext_size, valid_bits;
                uint32_t mask;
                uint16_t subformat;
                if (fread(&ext_size, 2, 1, f) != 1 ||
                    fread(&valid_bits, 2, 1, f) != 1 ||
                    fread(&mask, 4, 1, f) != 1 ||
                    fread(&subformat, 2, 1, f) != 1) return false;
                fmt = subformat;
                fseek(f, (long)size - 16 - 10, SEEK_CUR);
            } else if (size > 16) {
                fseek(f, (long)size - 16, SEEK_CUR);
            }
            h->format = fmt;
            h->channels = ch;
            h->sample_rate = sr;
            h->bits = bits;
        } else if (memcmp(id, "data", 4) == 0) {
            h->data_offset = ftell(f);
            h->data_bytes = size;
            fseek(f, (long)size + (size & 1), SEEK_CUR);
        } else {
            fseek(f, (long)size + (size & 1), SEEK_CUR);
        }
        if (h->data_offset >= 0 && h->sample_rate) break;
    }
    if (h->data_offset < 0) return false;
    // Clamp the declared data size to the bytes actually in the file, so
    // frame counts derived from it are trustworthy even for truncated files.
    const long avail = fsize - h->data_offset;
    if (avail < 0) return false;
    if ((long)h->data_bytes > avail) h->data_bytes = (uint32_t)avail;
    // Sanity-validate header fields before any arithmetic uses them: a
    // malformed bits-per-sample < 8 would otherwise make bits/8 == 0 and
    // turn the frame-count division into a process-killing SIGFPE.
    const bool bits_ok = h->bits == 8 || h->bits == 16 || h->bits == 24 ||
                         h->bits == 32 || h->bits == 64;
    return bits_ok && h->channels >= 1 && h->channels <= 256 &&
           h->sample_rate >= 1 && h->sample_rate <= 768000;
}

}  // namespace

int wav_info(const char* path, int* sr, int* channels, long* frames) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    WavHeader h;
    bool ok = read_header(f, &h);
    fclose(f);
    if (!ok) return -2;
    *sr = (int)h.sample_rate;
    *channels = (int)h.channels;
    *frames = (long)(h.data_bytes / (h.channels * (h.bits / 8)));
    return 0;
}

// Decode to f32 with the reference's audio_type channel semantics.
long wav_decode(const char* path, float* out, long max_frames, int audio_type) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    WavHeader h;
    if (!read_header(f, &h)) { fclose(f); return -2; }
    const int ch = h.channels;
    const int bytes = h.bits / 8;
    long frames = (long)(h.data_bytes / (ch * bytes));
    frames = std::min(frames, max_frames);
    if (audio_type == 2 && ch < 2) { fclose(f); return -3; }

    fseek(f, h.data_offset, SEEK_SET);
    const long chunk = 1 << 16;
    uint8_t* buf = (uint8_t*)malloc((size_t)chunk * ch * bytes);
    if (!buf) { fclose(f); return -4; }
    long done = 0;
    while (done < frames) {
        long n = std::min(chunk, frames - done);
        if ((long)fread(buf, (size_t)ch * bytes, (size_t)n, f) != n) break;
        // fast paths for PCM16 (the overwhelmingly common case)
        if (h.format != 3 && h.bits == 16) {
            const int16_t* s = (const int16_t*)buf;
            const float k = 1.0f / 32768.0f;
            if (ch == 1) {
                for (long i = 0; i < n; ++i) out[done + i] = s[i] * k;
            } else if (ch == 2 && audio_type != 0) {
                if (audio_type == 1) {
                    for (long i = 0; i < n; ++i)
                        out[done + i] = (s[2 * i] + s[2 * i + 1]) * (0.5f * k);
                } else {  // audio_type == 2
                    for (long i = 0; i < n; ++i) out[done + i] = s[2 * i + 1] * k;
                }
            } else {
                const float kc = k / (float)ch;
                for (long i = 0; i < n; ++i) {
                    float mix = 0.0f;
                    for (int c = 0; c < ch; ++c) mix += s[i * ch + c];
                    out[done + i] = mix * kc;
                }
            }
            done += n;
            continue;
        }
        for (long i = 0; i < n; ++i) {
            float mix = 0.0f;
            for (int c = 0; c < ch; ++c) {
                const uint8_t* p = buf + ((size_t)i * ch + c) * bytes;
                float v;
                if (h.format == 3 && h.bits == 32) {
                    memcpy(&v, p, 4);
                } else if (h.format == 3 && h.bits == 64) {
                    double d; memcpy(&d, p, 8); v = (float)d;
                } else if (h.bits == 16) {
                    int16_t s; memcpy(&s, p, 2); v = (float)s / 32768.0f;
                } else if (h.bits == 24) {
                    int32_t s = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
                    if (s >= (1 << 23)) s -= (1 << 24);
                    v = (float)s / 8388608.0f;
                } else if (h.bits == 32) {
                    int32_t s; memcpy(&s, p, 4); v = (float)s / 2147483648.0f;
                } else if (h.bits == 8) {
                    v = ((float)p[0] - 128.0f) / 128.0f;
                } else {
                    v = 0.0f;
                }
                if (audio_type == 2) {
                    if (c == 1) mix = v;
                } else if (audio_type == 1) {
                    if (c < 2) mix += v * 0.5f;
                } else {
                    mix += v / (float)ch;
                }
            }
            out[done + i] = mix;
        }
        done += n;
    }
    free(buf);
    fclose(f);
    return done;
}

// Polyphase rational resampler: y[m] = sum_k taps[k] * x_up[(m*down) - k]
// evaluated without materialising the upsampled signal. `taps` is an FIR
// prototype for the *upsampled* rate (cutoff min(pi/up, pi/down)), already
// scaled by `up` (scipy resample_poly convention).
//
// Classic base/phase decomposition: with pos = m*down + half (group-delay
// centered), phase = pos % up selects a tap sub-filter with stride `up`,
// and the input window is the contiguous run in[base-L+1 .. base] — no
// modulo or division in the inner loop.
long resample_poly_fir(const float* in, long n_in, float* out, long out_cap,
                       const float* taps, int n_taps, int up, int down) {
    // output length per scipy.resample_poly: ceil(n_in * up / down)
    long n_out = (n_in * (long)up + down - 1) / down;
    if (n_out > out_cap) n_out = out_cap;
    const int half = n_taps / 2;  // group delay compensation (odd-length FIR)

    for (long m = 0; m < n_out; ++m) {
        const long pos = m * (long)down + half;
        const long base = pos / up;        // newest input sample index used
        const int phase = (int)(pos % up); // tap offset for this output
        float acc = 0.0f;
        // tap index k = phase + i*up pairs with input index base - i
        long i_end = (n_taps - 1 - phase) / up;     // last usable i
        long i_lo = 0;
        if (base > n_in - 1) i_lo = base - (n_in - 1);   // clip future samples
        if (i_end > base) i_end = base;                  // clip before start
        const float* t = taps + phase + i_lo * up;
        const float* x = in + (base - i_lo);
        for (long i = i_lo; i <= i_end; ++i, t += up, --x) {
            acc += *t * *x;
        }
        out[m] = acc;
    }
    return n_out;
}

// SIMD-friendly variant: the caller pre-decomposes the FIR prototype into a
// contiguous reversed polyphase bank poly_rev[up][L] with
//   poly_rev[p][i] = taps[p + (L-1-i)*up]  (zero-padded),
// so each output is a contiguous dot product
//   y[m] = sum_i poly_rev[phase][i] * in[base - (L-1) + i],
// which the compiler auto-vectorizes. Boundary outputs (input window
// clipped) fall back to the guarded loop.
long resample_polyphase(const float* in, long n_in, float* out, long out_cap,
                        const float* poly_rev, int L, int up, int down,
                        int half) {
    long n_out = (n_in * (long)up + down - 1) / down;
    if (n_out > out_cap) n_out = out_cap;

    for (long m = 0; m < n_out; ++m) {
        const long pos = m * (long)down + half;
        const long base = pos / up;
        const int phase = (int)(pos % up);
        const float* t = poly_rev + (size_t)phase * L;
        const long start = base - (L - 1);
        float acc = 0.0f;
        if (start >= 0 && base < n_in) {
            const float* x = in + start;
            for (int i = 0; i < L; ++i) acc += t[i] * x[i];
        } else {
            for (int i = 0; i < L; ++i) {
                const long idx = start + i;
                if (idx >= 0 && idx < n_in) acc += t[i] * in[idx];
            }
        }
        out[m] = acc;
    }
    return n_out;
}

}  // extern "C"
