/* Native data-pipeline kernels for dense2sparse_vit_torch.
 *
 * The host-side image pipeline (decode -> transform -> normalize -> batch)
 * feeds the device; its hottest numpy stage is normalization, which allocates
 * three temporaries per image ((x/255 - mean) / std). This C kernel fuses it
 * into one pass: uint8 HWC in, float32 HWC out, per-channel scale/shift
 * precomputed as x * a[c] + b[c] with a = 1/(255*std), b = -mean/std.
 *
 * Built as a plain shared library and bound via ctypes. A threaded variant splits the batch across pthreads for multi-core
 * hosts. Python falls back to numpy when the library is unavailable.
 */

#include <stddef.h>
#include <stdint.h>
#include <pthread.h>

void d2s_normalize_u8_to_f32(
    const uint8_t *src,   /* (n_pixels, channels) interleaved */
    float *dst,
    size_t n_pixels,
    size_t channels,      /* <= 8 */
    const float *scale,   /* per-channel a = 1/(255*std) */
    const float *shift    /* per-channel b = -mean/std   */
) {
    if (channels == 3) {  /* unrolled RGB fast path */
        const float a0 = scale[0], a1 = scale[1], a2 = scale[2];
        const float b0 = shift[0], b1 = shift[1], b2 = shift[2];
        for (size_t i = 0; i < n_pixels; ++i) {
            const uint8_t *s = src + 3 * i;
            float *d = dst + 3 * i;
            d[0] = (float)s[0] * a0 + b0;
            d[1] = (float)s[1] * a1 + b1;
            d[2] = (float)s[2] * a2 + b2;
        }
        return;
    }
    for (size_t i = 0; i < n_pixels; ++i) {
        for (size_t c = 0; c < channels; ++c) {
            dst[i * channels + c] =
                (float)src[i * channels + c] * scale[c] + shift[c];
        }
    }
}

typedef struct {
    const uint8_t *src;
    float *dst;
    size_t n_pixels;
    size_t channels;
    const float *scale;
    const float *shift;
} d2s_norm_job;

static void *d2s_norm_worker(void *arg) {
    d2s_norm_job *j = (d2s_norm_job *)arg;
    d2s_normalize_u8_to_f32(
        j->src, j->dst, j->n_pixels, j->channels, j->scale, j->shift);
    return NULL;
}

void d2s_normalize_u8_to_f32_mt(
    const uint8_t *src,
    float *dst,
    size_t n_pixels,
    size_t channels,
    const float *scale,
    const float *shift,
    int n_threads
) {
    if (n_threads <= 1 || n_pixels < 1 << 16) {
        d2s_normalize_u8_to_f32(src, dst, n_pixels, channels, scale, shift);
        return;
    }
    if (n_threads > 16) n_threads = 16;
    pthread_t threads[16];
    d2s_norm_job jobs[16];
    size_t chunk = n_pixels / (size_t)n_threads;
    for (int t = 0; t < n_threads; ++t) {
        size_t start = (size_t)t * chunk;
        size_t count = (t == n_threads - 1) ? (n_pixels - start) : chunk;
        jobs[t] = (d2s_norm_job){
            src + start * channels, dst + start * channels,
            count, channels, scale, shift,
        };
        pthread_create(&threads[t], NULL, d2s_norm_worker, &jobs[t]);
    }
    for (int t = 0; t < n_threads; ++t) pthread_join(threads[t], NULL);
}
