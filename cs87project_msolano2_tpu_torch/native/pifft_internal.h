/* pifft_internal.h — shared internals between the core and the backends. */
#ifndef PIFFT_INTERNAL_H
#define PIFFT_INTERNAL_H

#include "pifft.h"

/* Twiddle plan for size n: one table per butterfly level.
 * Level l has butterfly size L = n >> l and L/2 entries
 * w[j] = exp(-2*pi*i*j/L).  All levels are packed into one allocation;
 * level l starts at offset n - (n >> l) (total n - 1 entries). */
typedef struct {
  int64_t n;
  int levels; /* log2(n) */
  pif_c32 *tw;
} pif_plan;

int pif_plan_init(pif_plan *plan, int64_t n);
void pif_plan_free(pif_plan *plan);

static inline const pif_c32 *pif_plan_level(const pif_plan *plan, int level) {
  return plan->tw + (plan->n - (plan->n >> level));
}

/* The whole per-processor algorithm: funnel (log2 p replicated half-butterfly
 * stages on a shrinking private copy) then tube (log2(n/p) full butterfly
 * stages on the private n/p segment), writing the segment into
 * out[pi*n/p .. (pi+1)*n/p).  buf0/buf1 are caller-provided scratch of
 * at least max(n/p, n/2) entries each (n entries when p == 1).
 * Fills t->funnel_ms / t->tube_ms with this processor's own phase times
 * when t is non-NULL. */
void pif_processor_run(const pif_plan *plan, int32_t p, int32_t pi,
                       const pif_c32 *in, pif_c32 *out, pif_c32 *buf0,
                       pif_c32 *buf1, pif_timers *t);

/* Scratch entries each of buf0/buf1 must hold for a (n, p) run. */
static inline int64_t pif_scratch_len(int64_t n, int32_t p) {
  return p == 1 ? n : (n / 2);
}

double pif_now_ms(void);

#endif /* PIFFT_INTERNAL_H */
