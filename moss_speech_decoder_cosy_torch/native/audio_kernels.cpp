// Host C++ serving primitives of the port (see native/__init__.py): the
// per-frame host work of the websocket path, pcm16 conversion and the
// Hamming cross-fade, as plain C ABI functions bound with ctypes.
//
// Every function works on caller-owned buffers and keeps no global state,
// so concurrent sessions may call them at once.

#include <cstdint>

extern "C" {

// float [-1, 1] -> int16 with clipping (truncation toward zero)
void pcm16_from_float(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float x = in[i];
        if (x > 1.0f) x = 1.0f;
        if (x < -1.0f) x = -1.0f;
        out[i] = (int16_t)(x * 32767.0f);
    }
}

void float_from_pcm16(const int16_t* in, int64_t n, float* out) {
    const float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * k;
}

// head[i] = head[i] * win_in[i] + tail[i] * win_out[i] over the overlap
// (flow_inference fade_in_out)
void crossfade(float* head, const float* tail, const float* win_in,
               const float* win_out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        head[i] = head[i] * win_in[i] + tail[i] * win_out[i];
    }
}

}  // extern "C"
