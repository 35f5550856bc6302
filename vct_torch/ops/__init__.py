"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``pair_scores`` (K1) — SAD / flow pair scores, ``csrc/pair_scores.cu``
* ``ssim`` (K4) — ``ssim_pair_scores``, mean 3x3-window SSIM of consecutive
  frames, ``csrc/ssim.cu``
* ``preprocess`` (K6) — ``normalize_frames``, uint8 -> f32 scale and
  per-channel standardize, ``csrc/normalize.cu`` (no serving path calls
  it, as in ``vct``)
* ``selective_scan`` (K3) — Mamba scan forward, ``csrc/selective_scan.cu``
* ``lstm`` — LSTM/GRU recurrences, ``csrc/lstm.cu``: ``lstm_stack`` /
  ``gru_stack`` (K2, a whole unidirectional stack) and ``lstm_scan`` /
  ``gru_scan`` (K5, one layer)

Every wrapper takes a CPU tensor to its plain PyTorch version and a CUDA
tensor to its kernel, and counts its kernel launches in ``<wrapper>.launches``.
"""
