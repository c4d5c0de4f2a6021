/* pifft_core.c — the pi-DFT core: complex/bit primitives, twiddle plan,
 * butterfly stages, and the per-processor funnel+tube routine.
 *
 * Algorithm (decimation-in-frequency radix-2, decomposed for zero
 * communication; cf. reference
 * cpu/pthreads/fourier-parallel-pi-cpu-pthreads.c:388-512):
 *
 *   For N = 2^m inputs and P = 2^k processors, processor Pi
 *     funnel: for i = 0..k-1, butterfly size L = N >> i.  The processor's
 *       final segment lies in one half of exactly one size-L butterfly; it
 *       computes only that half — top half  a + b,  bottom half
 *       (a - b) * w_L^j — halving its private working set each stage
 *       (N -> N/2 -> ... -> N/P; total work N(P-1)/P).
 *     tube: a complete local DIF FFT of its length-S = N/P working set
 *       (log2 S stages of full butterflies), all inside its own segment.
 *   The concatenated segments are the global DIF output, i.e. the DFT in
 *   bit-reversed index order; unscrambling is a separate gather that the
 *   timed path never performs (matching the reference, which gathers only
 *   in test mode).
 *
 * Design departures from the reference (deliberate, this is not a port):
 *   - twiddles come from a precomputed per-level table instead of a per
 *     element sincos (the reference recomputes omega every element,
 *     …pthreads.c:644-651 — a flop-heavy choice that would sandbag the CPU
 *     baseline and is exactly what SURVEY.md §7 says not to do on TPU);
 *   - plain-C bit helpers instead of De Bruijn / Dietz bit tricks;
 *   - one core shared by every backend instead of per-backend copies.
 */
#define _GNU_SOURCE
#include "pifft_internal.h"

#include <math.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* ---------------- timing ---------------- */

double pif_now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec * 1e-6;
}

/* ---------------- bit utilities ---------------- */

int pif_is_power_of_two(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

int pif_ilog2(int64_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    l++;
  }
  return l;
}

int64_t pif_bit_reverse(int64_t v, int bits) {
  int64_t r = 0;
  for (int i = 0; i < bits; i++) {
    r = (r << 1) | ((v >> i) & 1);
  }
  return r;
}

void pifft_bit_reverse_permute(int64_t n, const pif_c32 *in, pif_c32 *out) {
  int bits = pif_ilog2(n);
  for (int64_t k = 0; k < n; k++) {
    out[k] = in[pif_bit_reverse(k, bits)];
  }
}

/* ---------------- twiddle plan ---------------- */

int pif_plan_init(pif_plan *plan, int64_t n) {
  plan->n = n;
  plan->levels = pif_ilog2(n);
  plan->tw = NULL;
  if (n < 2) return 0;
  plan->tw = (pif_c32 *)malloc((size_t)(n - 1) * sizeof(pif_c32));
  if (!plan->tw) return 1;
  for (int l = 0; l < plan->levels; l++) {
    int64_t L = n >> l;
    int64_t half = L >> 1;
    pif_c32 *w = plan->tw + (n - (n >> l));
    double step = -2.0 * M_PI / (double)L;
    for (int64_t j = 0; j < half; j++) {
      w[j].re = (float)cos(step * (double)j);
      w[j].im = (float)sin(step * (double)j);
    }
  }
  return 0;
}

void pif_plan_free(pif_plan *plan) {
  free(plan->tw);
  plan->tw = NULL;
}

/* ---------------- butterfly stages (L1) ---------------- */

static inline pif_c32 c_add(pif_c32 a, pif_c32 b) {
  pif_c32 r = {a.re + b.re, a.im + b.im};
  return r;
}

static inline pif_c32 c_sub(pif_c32 a, pif_c32 b) {
  pif_c32 r = {a.re - b.re, a.im - b.im};
  return r;
}

static inline pif_c32 c_mul(pif_c32 a, pif_c32 b) {
  pif_c32 r = {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
  return r;
}

/* Top half of one size-(2*half) DIF butterfly: dst[j] = a[j] + b[j]. */
static void stage_half_top(pif_c32 *dst, const pif_c32 *a, const pif_c32 *b,
                           int64_t half) {
  for (int64_t j = 0; j < half; j++) dst[j] = c_add(a[j], b[j]);
}

/* Bottom half: dst[j] = (a[j] - b[j]) * w[j]. */
static void stage_half_bottom(pif_c32 *dst, const pif_c32 *a, const pif_c32 *b,
                              const pif_c32 *w, int64_t half) {
  for (int64_t j = 0; j < half; j++) dst[j] = c_mul(c_sub(a[j], b[j]), w[j]);
}

/* One full DIF stage over a length-len working set with butterfly size L:
 * for every size-L block, both halves.  dst != src. */
static void stage_full(pif_c32 *dst, const pif_c32 *src, const pif_c32 *w,
                       int64_t len, int64_t L) {
  int64_t half = L >> 1;
  for (int64_t base = 0; base < len; base += L) {
    stage_half_top(dst + base, src + base, src + base + half, half);
    stage_half_bottom(dst + base + half, src + base, src + base + half, w,
                      half);
  }
}

/* ---------------- per-processor routine (L2 body) ---------------- */

void pif_processor_run(const pif_plan *plan, int32_t p, int32_t pi,
                       const pif_c32 *in, pif_c32 *out, pif_c32 *buf0,
                       pif_c32 *buf1, pif_timers *t) {
  int64_t n = plan->n;
  int k = pif_ilog2(p);
  int64_t seg = n / p;

  pif_c32 *cur = buf0;
  pif_c32 *nxt = buf1;
  const pif_c32 *src = in; /* funnel stage 0 reads the shared input */
  int64_t len = n;

  double t0 = pif_now_ms();

  /* funnel: keep only the half that contains this processor's segment.
   * Stage i's half choice is bit (k-1-i) of pi (most significant first). */
  for (int i = 0; i < k; i++) {
    int64_t half = len >> 1;
    int bottom = (pi >> (k - 1 - i)) & 1;
    const pif_c32 *w = pif_plan_level(plan, i);
    if (bottom)
      stage_half_bottom(cur, src, src + half, w, half);
    else
      stage_half_top(cur, src, src + half, half);
    src = cur;
    pif_c32 *tmp = cur == buf0 ? buf1 : buf0;
    nxt = cur;
    cur = tmp;
    len = half;
  }

  double t1 = pif_now_ms();

  /* tube: full local DIF FFT of the length-seg working set. */
  if (k == 0) {
    /* p == 1: no funnel ran; seed the working set from the input. */
    memcpy(nxt, in, (size_t)n * sizeof(pif_c32));
  }
  /* after the funnel loop, `nxt` holds the current working set */
  pif_c32 *a = nxt;
  pif_c32 *b = cur;
  for (int i = 0; i < pif_ilog2(seg); i++) {
    const pif_c32 *w = pif_plan_level(plan, k + i);
    stage_full(b, a, w, seg, seg >> i);
    pif_c32 *tmp = a;
    a = b;
    b = tmp;
  }
  memcpy(out + (int64_t)pi * seg, a, (size_t)seg * sizeof(pif_c32));

  double t2 = pif_now_ms();
  if (t) {
    t->funnel_ms = t1 - t0;
    t->tube_ms = t2 - t1;
  }
}
