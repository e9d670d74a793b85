"""Entry points above the plan API: ``serve_fft`` (the transform-serving
layer).  Importing this package builds no kernel and touches no CUDA
state."""
