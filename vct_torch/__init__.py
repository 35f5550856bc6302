"""vct_torch — the PyTorch/CUDA port of ``vct`` for NVIDIA Hopper (H100).

The package mirrors ``vct``'s module layout so each module's counterpart is
easy to find. It imports nothing of ``vct`` (nor JAX): what it needs from the
framework-free ``vct`` modules it keeps as its own copies. Its hand-written
CUDA kernels live in ``vct_torch/csrc`` and are built on first CUDA use
(``vct_torch.ops._build``).

It covers the serving path: on-device SAD/flow frame selection (kernel
``pair_scores``) and SSIM frame selection (kernel ``ssim_pair_scores``),
the bilinear resize, every model family of ``vct`` (the LRCN on any of the
eleven backbones with a Mamba head, kernel ``selective_scan``, or an
LSTM/GRU head, kernels ``lstm_stack`` / ``gru_stack`` and ``lstm_scan`` /
``gru_scan``; VideoMamba on ``selective_scan``; the scratch CNNs ``lrcn2``
and ``td_cnn_lstm``), and the batched softmax serving entry points in
``vct_torch.serve.deployment``; training (``vct_torch.train``) with the
backward kernels; captioning (``vct_torch.caption``: the S2VT v2 and 1s2vt,
transformer and v1 LSTM/GRU captioners, on-device beam search, the caption
trainer and ``python -m vct_torch.caption``), on plain PyTorch as in
``vct``, no kernel on its path; and the frame normalize kernel
``normalize_frames``, which no path calls, as in ``vct``. The host data
path (``vct_torch.data``: decode, the host samplers, the clip cache, ingest)
feeds training from a dataset directory (``python -m vct_torch.train
--data.dataset_path DIR``, with ``--data.stream true`` out of core) and the
serving CLI (``python -m vct_torch.serve.deployment``). One-file
``torch.export`` artifacts of a classifier or a captioner, with the weights
and the kernels inside, are written and served by ``vct_torch.serve.aot``.
Training runs across ranks (one process a rank, ``torchrun``) and serving
across cards (a replica a card) through ``vct_torch.parallel``.

Importing the package, or its host data path, imports no torch: the
decode workers import that path alone.
"""

from vct_torch.device import resolve_device

__all__ = ["resolve_device"]
