"""One config module per assigned architecture (FULL = exact assigned
config; SMOKE = reduced same-family config for CPU tests), plus the paper's
own 2-D FFT workload configs in ``paper_fft``.  Plain dataclasses, a copy of
the reference package's ``configs`` so that this package imports nothing of
it."""

from repro_torch.configs.base import (ArchConfig, MoECfg, MLACfg, SSMCfg,
                                      XLSTMCfg, HybridCfg, ShapeCfg, SHAPES,
                                      TrainCfg)

__all__ = ["ArchConfig", "MoECfg", "MLACfg", "SSMCfg", "XLSTMCfg",
           "HybridCfg", "ShapeCfg", "SHAPES", "TrainCfg"]
