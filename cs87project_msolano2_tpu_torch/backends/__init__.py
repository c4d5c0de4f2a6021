"""Backends behind the reference's run contract: the native C core
(``serial``, ``pthreads``) and the tensor backends (``torch``,
``torch-scan``, ``torch-unrolled``, ``cuda``, ``einsum``)."""
