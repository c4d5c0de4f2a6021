/* main.c — standalone CLI for the native pi-FFT backends.
 *
 * Usage parity with the reference executables
 * (…pthreads.c:293-302: `{ -n <n> -p <p> [-o] | -t }`), plus `-b` to pick a
 * backend through the dispatch table:
 *
 *   pifft { -n <n> -p <p> [-o] [-b serial|pthreads] | -t }
 *
 * Non-test runs print one TSV row `n p total_ms funnel_ms tube_ms`
 * (with a header line unless -o), the contract the harness and the
 * analysis layer consume (reference …pthreads.c:487-491).
 */
#define _POSIX_C_SOURCE 200809L
#include "pifft.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

static void show_usage(const char *argv0) {
  fprintf(stderr,
          "usage: %s { -n <size> -p <processors> [-o] [-b <backend>] | -t "
          "[-b <backend>] }\n"
          "  -n <size>        input length (power of two)\n"
          "  -p <processors>  virtual processor count (power of two, <= n,\n"
          "                   <= backend capacity)\n"
          "  -t               golden test mode (forces n=8, checks the exact\n"
          "                   expected DFT, prints pass/fail)\n"
          "  -o               omit the TSV header (machine-readable output)\n"
          "  -b <backend>     serial | pthreads (default pthreads)\n",
          argv0);
}

/* splitmix32: deterministic pseudo-random init, amplitude 1/sqrt(n)
 * (the reference initializes random +-1/sqrt(N), …pthreads.c:244-247). */
static unsigned int mix32(unsigned int x) {
  x += 0x9e3779b9u;
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

int main(int argc, char **argv) {
  int64_t n = 0;
  long p = 0;
  int test_mode = 0, no_header = 0;
  const char *backend = "pthreads";

  int opt;
  while ((opt = getopt(argc, argv, "n:p:b:toh")) != -1) {
    switch (opt) {
      case 'n': n = atoll(optarg); break;
      case 'p': p = atol(optarg); break;
      case 'b': backend = optarg; break;
      case 't': test_mode = 1; break;
      case 'o': no_header = 1; break;
      case 'h': show_usage(argv[0]); return 0;
      default: show_usage(argv[0]); return 2;
    }
  }
  if (!pif_get_backend(backend)) {
    fprintf(stderr, "error: unknown backend '%s'\n", backend);
    return 2;
  }

  if (test_mode) {
    for (long tp = 1; tp <= 8; tp *= 2) {
      int rc = pifft_golden_test(backend, (int32_t)tp);
      printf("golden test: backend=%s n=8 p=%ld ... %s\n", backend, tp,
             rc == 0 ? "PASSED" : "FAILED");
      if (rc) return 1;
    }
    return 0;
  }

  if (n <= 0 || p <= 0) {
    show_usage(argv[0]);
    return 2;
  }
  if (!pif_is_power_of_two(n) || !pif_is_power_of_two(p) || p > n) {
    fprintf(stderr, "error: n and p must be powers of two with p <= n\n");
    return 2;
  }
  int cap = pifft_capacity(backend);
  if (cap > 0 && p > cap) {
    fprintf(stderr, "error: p=%ld exceeds backend '%s' capacity %d\n", p,
            backend, cap);
    return 2;
  }

  pif_c32 *in = malloc((size_t)n * sizeof(pif_c32));
  pif_c32 *out = malloc((size_t)n * sizeof(pif_c32));
  if (!in || !out) {
    fprintf(stderr, "error: allocation failed\n");
    return 3;
  }
  float amp = (float)(1.0 / sqrt((double)n));
  for (int64_t i = 0; i < n; i++) {
    unsigned int h = mix32((unsigned int)i * 2u + 1u);
    unsigned int g = mix32((unsigned int)i * 2u + 2u);
    in[i].re = amp * (2.0f * ((float)h / 4294967295.0f) - 1.0f);
    in[i].im = amp * (2.0f * ((float)g / 4294967295.0f) - 1.0f);
  }

  double timers[3] = {0, 0, 0};
  int rc = pifft_run(backend, n, (int32_t)p, in, out, timers);
  if (rc) {
    fprintf(stderr, "error: run failed (rc=%d)\n", rc);
    return 1;
  }
  if (!no_header) printf("n\tp\ttotal_ms\tfunnel_ms\ttube_ms\n");
  printf("%lld\t%ld\t%.6f\t%.6f\t%.6f\n", (long long)n, p, timers[0],
         timers[1], timers[2]);

  free(in);
  free(out);
  return 0;
}
