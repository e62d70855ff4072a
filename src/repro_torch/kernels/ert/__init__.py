"""ERT micro-kernels: triad, fma_chain and the GEMM (port of
``repro.kernels.ert``)."""
