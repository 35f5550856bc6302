"""Captioning: the port of ``vct/caption/`` (S2VT v2 and 1s2vt, the
transformer and the v1 LSTM/GRU captioners, on-device beam search, the
caption trainer and ``python -m vct_torch.caption``)."""

from vct_torch.caption.beam import beam_search, decode_tokens, greedy_decode  # noqa: F401
from vct_torch.caption.bleu import corpus_average_bleu, sentence_bleu  # noqa: F401
from vct_torch.caption.data import encode_caption, preprocess_annotations  # noqa: F401
from vct_torch.caption.models import S2VTModel  # noqa: F401
from vct_torch.caption.train import CaptionTrainer, build_captioner  # noqa: F401
from vct_torch.caption.vocab import Vocabulary, tokenize_caption  # noqa: F401
