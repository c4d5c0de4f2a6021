"""The benchmark of the PyTorch and CUDA port (``cs87project_msolano2_tpu_torch``).

``spec`` finds a cell's configuration, traffic, entry, reference,
metrics and limits by the names in ``BENCHMARK.json``; ``cell`` runs one
cell: the closed-loop stream of ``stream``, the profiler reading of
``trace``, the comparison of ``check`` against the configuration's
reference, and the metric readers.  Nothing here imports JAX or the JAX
package.

An entry, ``entries/<name>.py``, is the program's call a traffic mix
drives.  It defines

* ``make_inputs(shape, count, seed, device, config)``: `count` distinct
  input tuples of tensors, drawn on `device` from `seed`;
* ``bind(precision, **kwargs)``: ``call(inputs)``, which runs the entry
  on one input tuple with the traffic's ``kwargs`` and returns its
  output as a tuple of tensors;
* ``flops(shape, **kwargs)``: the operations of one call;
* optionally ``plan(shape, precision, device, **kwargs)``: a line that
  says what the program resolved to serve the calls.

A call's outputs are held against the reference as ``check.answer``
gives them: one tensor as it is, float re and im planes as complex.

A reference, ``reference/<name>.py``, defines ``expected(inputs,
**reference_args)``: from one call's inputs as numpy arrays, the answer
as a numpy array.
"""
