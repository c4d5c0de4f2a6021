/* pifft_backends.c — backend-dispatch table over the pi-DFT core.
 *
 * Two native backends register here:
 *   serial   — the P virtual processors run one after another on the calling
 *              thread (deterministic; useful for testing p-semantics and as
 *              the p=1 baseline).
 *   pthreads — one OS thread per processor, pinned to bit-reversed core ids
 *              so funnel-tree siblings land far apart (the reference pins the
 *              same way, …pthreads.c:339-344).
 *
 * The Python package's `cpu` backend calls the flat pifft_* API below via
 * ctypes; the TPU backends (jax / pallas) live on the Python side behind the
 * same dispatch shape.
 */
#define _GNU_SOURCE
#include "pifft_internal.h"

#include <pthread.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#ifdef __linux__
#include <sched.h>
#endif

/* ---------------- capacity probes (L3) ---------------- */

int pifft_num_cores(void) {
  long v = sysconf(_SC_NPROCESSORS_ONLN);
  return v > 0 ? (int)v : 1;
}

static int cap_unlimited(void) { return 0; }

/* ---------------- shared run scaffolding ---------------- */

static int check_args(int64_t n, int32_t p, const pif_c32 *in,
                      const pif_c32 *out) {
  if (!in || !out || in == out) return 1;
  if (!pif_is_power_of_two(n) || !pif_is_power_of_two((int64_t)p)) return 1;
  if ((int64_t)p > n) return 1;
  return 0;
}

/* ---------------- serial backend ---------------- */

static int serial_run(int64_t n, int32_t p, const pif_c32 *in, pif_c32 *out,
                      pif_timers *t) {
  if (check_args(n, p, in, out)) return 1;
  pif_plan plan;
  if (pif_plan_init(&plan, n)) return 2;
  int64_t slen = pif_scratch_len(n, p);
  pif_c32 *buf = (pif_c32 *)malloc((size_t)(2 * slen) * sizeof(pif_c32));
  if (!buf) {
    pif_plan_free(&plan);
    return 2;
  }
  double t0 = pif_now_ms();
  for (int32_t pi = 0; pi < p; pi++) {
    pif_timers pt;
    pif_processor_run(&plan, p, pi, in, out, buf, buf + slen,
                      pi == 0 ? &pt : NULL);
    if (pi == 0 && t) {
      t->funnel_ms = pt.funnel_ms;
      t->tube_ms = pt.tube_ms;
    }
  }
  if (t) t->total_ms = pif_now_ms() - t0;
  free(buf);
  pif_plan_free(&plan);
  return 0;
}

/* ---------------- pthreads backend ---------------- */

typedef struct {
  const pif_plan *plan;
  int32_t p, pi;
  const pif_c32 *in;
  pif_c32 *out;
  pif_timers timers;
  int rc;
} worker_arg;

static void *worker_main(void *vp) {
  worker_arg *a = (worker_arg *)vp;
  int64_t slen = pif_scratch_len(a->plan->n, a->p);
  pif_c32 *buf = (pif_c32 *)malloc((size_t)(2 * slen) * sizeof(pif_c32));
  if (!buf) {
    a->rc = 2;
    return NULL;
  }
  pif_processor_run(a->plan, a->p, a->pi, a->in, a->out, buf, buf + slen,
                    &a->timers);
  free(buf);
  a->rc = 0;
  return NULL;
}

static int pthreads_run(int64_t n, int32_t p, const pif_c32 *in, pif_c32 *out,
                        pif_timers *t) {
  if (check_args(n, p, in, out)) return 1;
  pif_plan plan;
  if (pif_plan_init(&plan, n)) return 2;

  pthread_t *tids = (pthread_t *)malloc((size_t)p * sizeof(pthread_t));
  worker_arg *args = (worker_arg *)calloc((size_t)p, sizeof(worker_arg));
  int rc = 0;
  if (!tids || !args) {
    rc = 2;
    goto done;
  }

  int ncores = pifft_num_cores();
  int corebits = pif_ilog2(ncores); /* floor(log2(ncores)) */

  double t0 = pif_now_ms();
  for (int32_t pi = 0; pi < p; pi++) {
    args[pi].plan = &plan;
    args[pi].p = p;
    args[pi].pi = pi;
    args[pi].in = in;
    args[pi].out = out;

    pthread_attr_t attr;
    pthread_attr_init(&attr);
#ifdef __linux__
    /* Pin processor Pi to core bit_reverse(Pi): funnel-tree siblings (ids
     * differing in a high bit) get cores differing in a low bit and vice
     * versa, spreading siblings across the physical topology. */
    if (ncores > 1) {
      /* bit-reverse within the largest power-of-two core subset; threads
       * beyond that subset spill onto the remaining cores via the offset
       * (full-core coverage is not guaranteed when ncores is not a power
       * of two — siblings-apart placement is what matters here). */
      int64_t mask = (1 << corebits) - 1;
      int core = (int)((pif_bit_reverse(pi & mask, corebits) +
                        (int64_t)(pi >> corebits)) %
                       ncores);
      cpu_set_t set;
      CPU_ZERO(&set);
      CPU_SET(core, &set);
      pthread_attr_setaffinity_np(&attr, sizeof(set), &set);
    }
#endif
    if (pthread_create(&tids[pi], &attr, worker_main, &args[pi]) != 0) {
      /* fall back to unpinned create before giving up */
      pthread_attr_destroy(&attr);
      pthread_attr_init(&attr);
      if (pthread_create(&tids[pi], &attr, worker_main, &args[pi]) != 0) {
        pthread_attr_destroy(&attr);
        for (int32_t q = 0; q < pi; q++) pthread_join(tids[q], NULL);
        rc = 3;
        goto done;
      }
    }
    pthread_attr_destroy(&attr);
  }
  for (int32_t pi = 0; pi < p; pi++) pthread_join(tids[pi], NULL);
  double t1 = pif_now_ms();

  for (int32_t pi = 0; pi < p; pi++) {
    if (args[pi].rc) rc = args[pi].rc;
  }
  if (!rc && t) {
    t->total_ms = t1 - t0;
    t->funnel_ms = args[0].timers.funnel_ms;
    t->tube_ms = args[0].timers.tube_ms;
  }

done:
  free(tids);
  free(args);
  pif_plan_free(&plan);
  return rc;
}

/* ---------------- registry + flat API ---------------- */

static const pif_backend BACKENDS[] = {
    {"serial", cap_unlimited, serial_run},
    {"pthreads", pifft_num_cores, pthreads_run},
};

int pif_num_backends(void) {
  return (int)(sizeof(BACKENDS) / sizeof(BACKENDS[0]));
}

const char *pif_backend_name(int i) {
  if (i < 0 || i >= pif_num_backends()) return NULL;
  return BACKENDS[i].name;
}

const pif_backend *pif_get_backend(const char *name) {
  for (int i = 0; i < pif_num_backends(); i++) {
    if (strcmp(BACKENDS[i].name, name) == 0) return &BACKENDS[i];
  }
  return NULL;
}

int pifft_run(const char *backend, int64_t n, int32_t p, const pif_c32 *in,
              pif_c32 *out, double *timers3) {
  const pif_backend *b = pif_get_backend(backend);
  if (!b) return -1;
  pif_timers t = {0, 0, 0};
  int rc = b->run(n, p, in, out, &t);
  if (timers3) {
    timers3[0] = t.total_ms;
    timers3[1] = t.funnel_ms;
    timers3[2] = t.tube_ms;
  }
  return rc;
}

int pifft_capacity(const char *backend) {
  const pif_backend *b = pif_get_backend(backend);
  if (!b) return -1;
  return b->capacity();
}

/* ---------------- golden test (L3 verify) ----------------
 * The reference's `-t` mode: N=8 fixed input (0,1,0,1,0,1,0,1), expected
 * DFT exactly (4,0,0,0,-4,0,0,0) with exact float equality
 * (…pthreads.c:689-705). */
int pifft_golden_test(const char *backend, int32_t p) {
  enum { N = 8 };
  pif_c32 in[N], pi_out[N], nat[N];
  for (int i = 0; i < N; i++) {
    in[i].re = (float)(i & 1);
    in[i].im = 0.0f;
  }
  if (p < 1 || p > N) return 10;
  if (pifft_run(backend, N, p, in, pi_out, NULL)) return 11;
  pifft_bit_reverse_permute(N, pi_out, nat);
  static const float expect_re[N] = {4.f, 0.f, 0.f, 0.f, -4.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < N; i++) {
    if (nat[i].re != expect_re[i] || nat[i].im != 0.0f) return 12;
  }
  return 0;
}
