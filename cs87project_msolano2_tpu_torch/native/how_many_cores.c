/* how_many_cores.c — CPU capacity probe executable.
 *
 * Prints the number of online cores; the harness clips its p-sweep with it
 * (parity with the reference probe cpu/pthreads/how-many-cpu-cores.c:19-32
 * and its use in run-experiments-and-analyze-results:42-47).
 */
#include "pifft.h"

#include <stdio.h>

int main(void) {
  printf("%d\n", pifft_num_cores());
  return 0;
}
