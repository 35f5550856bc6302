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

Importing ``vct_torch.ops.<kernel>`` registers its forward entry point as
an operator in the ``vct_torch`` namespace (``torch.ops.vct_torch.*``:
``pair_scores``, ``ssim_pair_scores``, ``selective_scan``, ``rnn_scan``,
``rnn_stack``; K6 has none, no path calls it) without building anything.
An operator's CPU implementation is the plain PyTorch version and its CUDA
implementation the kernel, whose launch it counts in ``<wrapper>.launches``;
its fake implementation gives the output's shape and dtype, so
``torch.export`` records the operator in a graph. Every wrapper calls its
operator where no input requires a gradient; where one does, a CUDA tensor
goes to an autograd node around the same counted launch and a CPU tensor
to the plain version. The library is built at the first CUDA launch.
"""
