/* pifft.h — public API of the native pi-FFT core.
 *
 * A communication-free radix-2 Cooley–Tukey FFT ("pi-DFT"): P processors,
 * each of which runs log2(P) replicated "funnel" half-butterfly stages on a
 * private shrinking copy of the input, followed by log2(N/P) "tube" stages
 * confined to its own N/P output segment.  No inter-processor data flow
 * after initialization.
 *
 * This is a from-scratch re-design of the reference implementation
 * (elenasolano/CS87Project-msolano2, see e.g.
 * benchmark/fourier/parallel/pi/cpu/pthreads/fourier-parallel-pi-cpu-pthreads.c:312-512
 * for the algorithm), restructured the way the reference should have been:
 * ONE core + a backend-dispatch table (`pif_backend`) instead of three
 * triplicated monoliths.  The Python package registers this library as the
 * `cpu` backend next to the JAX/Pallas TPU backends.
 */
#ifndef PIFFT_H
#define PIFFT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Complex sample: layout-compatible with numpy complex64. */
typedef struct {
  float re;
  float im;
} pif_c32;

/* Per-run phase timers, milliseconds.  funnel/tube are processor 0's own
 * phase times (the reference reports thread 0's timers); total is the
 * coordinator's wall-clock around the whole parallel region. */
typedef struct {
  double total_ms;
  double funnel_ms;
  double tube_ms;
} pif_timers;

/* Backend-dispatch table.  `run` computes the pi-DFT of `in` (length n,
 * n a power of two) with p virtual processors (p a power of two, p <= n),
 * writing the result in "pi layout" — the global decimation-in-frequency
 * order, i.e. out[j] = X[bit_reverse(j)] — with processor Pi owning the
 * contiguous segment [Pi*n/p, (Pi+1)*n/p).  Returns 0 on success. */
typedef struct {
  const char *name;
  int (*capacity)(void); /* max sensible p on this machine (<=0: unlimited) */
  int (*run)(int64_t n, int32_t p, const pif_c32 *in, pif_c32 *out,
             pif_timers *t); /* in and out must not alias */
} pif_backend;

/* ---- backend registry ---- */
const pif_backend *pif_get_backend(const char *name); /* NULL if unknown */
int pif_num_backends(void);
const char *pif_backend_name(int i);

/* ---- flat C API (ctypes-friendly) ---- */

/* timers3 = {total_ms, funnel_ms, tube_ms}; may be NULL. Returns 0 on ok,
 * nonzero on bad arguments / unknown backend / allocation failure. */
int pifft_run(const char *backend, int64_t n, int32_t p, const pif_c32 *in,
              pif_c32 *out, double *timers3);

/* Max sensible p for a backend (e.g. online cores for "pthreads").
 * Returns 0 if the backend imposes no limit, -1 for an unknown backend. */
int pifft_capacity(const char *backend);

/* Number of online CPU cores (the reference's how-many-cpu-cores probe,
 * cpu/pthreads/how-many-cpu-cores.c:19-32). */
int pifft_num_cores(void);

/* out[k] = in[bit_reverse(k)] over log2(n) bits: converts pi layout to
 * natural frequency order.  in != out required. */
void pifft_bit_reverse_permute(int64_t n, const pif_c32 *in, pif_c32 *out);

/* Run the built-in golden test (8-point fixed input, exact expected DFT)
 * on a backend with the given p.  Returns 0 on pass. */
int pifft_golden_test(const char *backend, int32_t p);

/* ---- bit utilities (exposed for tests) ---- */
int pif_is_power_of_two(int64_t v);
int pif_ilog2(int64_t v);                 /* v must be a power of two */
int64_t pif_bit_reverse(int64_t v, int bits);

#ifdef __cplusplus
}
#endif

#endif /* PIFFT_H */
