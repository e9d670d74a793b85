"""The paper's own workload: 2-D DFT of complex N x N signal matrices.
Problem-size sweep follows the paper (N in {128, 192, ...} step 64), scaled
to the benchmark budget of this container."""

PAPER_N_STEP = 64
PAPER_N_MIN = 128
PAPER_N_MAX = 64000          # full paper sweep (reference)
BENCH_N_VALUES = list(range(128, 1153, 64))   # CPU-budget sweep
BENCH_ABSTRACT_PROCS = 4     # paper uses p in {2, 4} groups
EPS_TOLERANCE = 0.05         # paper's 5% identical-speed tolerance
