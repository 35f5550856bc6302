"""vct_torch's captioning models and the captioning host code against vct's,
on the CPU.

Each captioner family (S2VT v2, 1s2vt, the transformer, the v1 LSTM and GRU)
is built in vct and in the port at a small size (resnet18 on 32x32 frames,
T=3, max_len 6, width 16; tests/torch_caption_common.py), one seeded random
variables tree carried into the port by ``vct_torch.bridge``; the log-probs
of both, teacher-forced and free-running, agree within atol = rtol = 1e-5
(f32, other summation orders). The vocabulary, the annotation parser,
``encode_caption`` and BLEU are the port's own copies and give vct's
results exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_caption_common as common
from vct.caption import bleu as vct_bleu
from vct.caption.data import encode_caption as vct_encode_caption
from vct.caption.data import preprocess_annotations as vct_preprocess_annotations
from vct.caption.vocab import Vocabulary as VctVocabulary
from vct.caption.vocab import tokenize_caption as vct_tokenize_caption
from vct_torch.bridge import load_vct_variables
from vct_torch.caption import bleu
from vct_torch.caption.data import CaptionArrayLoader, as_caption_loader, encode_caption
from vct_torch.caption.data import preprocess_annotations
from vct_torch.caption.train import CaptionTrainer, build_captioner
from vct_torch.caption.vocab import Vocabulary, tokenize_caption
from vct_torch.models.layers import Dropout

TOL = 1e-5
CAPTIONS = ["A man, is cooking!", "a dog runs FAST", "a man runs.", "Two dogs; a cat",
            "the man is cooking food"]


@pytest.fixture(scope="module", params=list(common.KINDS))
def kind_pair(request):
    return request.param, common.pair(request.param)


# ---------------------------------------------------------------------------
# host code: vocab, annotations, encode, BLEU


@pytest.mark.parametrize("threshold", [1, 2])
def test_vocab_matches_vct(tmp_path, threshold):
    ours, theirs = Vocabulary(threshold), VctVocabulary(threshold)
    ours.build_vocabulary(CAPTIONS)
    theirs.build_vocabulary(CAPTIONS)
    assert ours.word2idx == theirs.word2idx and ours.idx2word == theirs.idx2word
    assert ours.to_dict() == theirs.to_dict()
    assert Vocabulary.from_dict(theirs.to_dict()).word2idx == theirs.word2idx
    for text in CAPTIONS + ["zebra and a man"]:
        assert tokenize_caption(text) == vct_tokenize_caption(text)
        tokens = tokenize_caption(text)
        assert ours.numericalize(tokens) == theirs.numericalize(tokens)
    assert ours.denumericalize(range(len(ours))) == theirs.denumericalize(range(len(theirs)))
    ours.save(str(tmp_path / "v.json"))
    assert VctVocabulary.load(str(tmp_path / "v.json")).word2idx == theirs.word2idx
    assert (ours["<pad>"], ours["<start>"], ours["<end>"], ours["<unk>"]) == (0, 1, 2, 3)


def test_annotation_parser_and_encode_match_vct(tmp_path, capsys):
    path = tmp_path / "ann.txt"
    path.write_text("vid1 a man is cooking\n\nvid2 a dog runs\nbadline\nvid3 a man is cooking\n"
                    "vid4 Two dogs, a cat!\n")
    got = preprocess_annotations(str(path))
    printed = capsys.readouterr().out
    assert got == vct_preprocess_annotations(str(path))
    assert printed == capsys.readouterr().out and "badline" in printed
    vocab = VctVocabulary()
    vocab.build_vocabulary(got[1])
    for caption in got[1] + ["an unknown caption here"]:
        for max_len in (2, 4, 6, 30):
            ours, theirs = encode_caption(caption, vocab, max_len), vct_encode_caption(
                caption, vocab, max_len)
            assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_bleu_matches_vct():
    refs = [["a", "man", "is", "cooking", "food"], ["a", "person", "cooks"]]
    hyps = [["a", "man", "is", "cooking", "rice"], ["a", "man", "is", "cooking", "food"],
            ["a", "dog"], [], ["cooking", "a", "man", "is", "a", "man"]]
    for hyp in hyps:
        assert bleu.sentence_bleu(refs, hyp) == vct_bleu.sentence_bleu(refs, hyp)
        assert bleu._native_sentence_bleu(refs, hyp) == vct_bleu._native_sentence_bleu(refs, hyp)
    pairs = [(refs, h) for h in hyps]
    assert bleu.corpus_average_bleu(pairs) == vct_bleu.corpus_average_bleu(pairs)
    assert bleu.corpus_average_bleu([]) == 0.0


def test_caption_loader_is_the_array_loader():
    videos, captions = common.inputs(n=5)
    loader = as_caption_loader(videos, captions, 2)
    assert isinstance(loader, CaptionArrayLoader) and as_caption_loader(loader) is loader
    batches = list(loader.epoch(np.random.RandomState(3)))
    assert [int(m.sum()) for _, _, m in batches] == [2, 2, 1]
    with pytest.raises(TypeError, match="no captions"):
        as_caption_loader(videos)


# ---------------------------------------------------------------------------
# the captioners against vct


def test_log_probs_match_vct(kind_pair):
    """Teacher-forced log-probs (logit i scored against target i, <start>
    fed first) and the free-running ones within 1e-5 of vct's."""
    kind, (vct_model, variables, model, _) = kind_pair
    videos, captions = common.inputs()
    want = np.asarray(vct_model.apply(variables, jnp.asarray(videos), jnp.asarray(captions)))
    free_want = np.asarray(vct_model.apply(variables, jnp.asarray(videos)))
    with torch.no_grad():
        got = model(torch.from_numpy(videos), torch.from_numpy(captions)).numpy()
        free = model(torch.from_numpy(videos)).numpy()
    assert got.shape == (common.B, common.MAX_LEN, len(common.vocab()))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=kind)
    np.testing.assert_allclose(free, free_want, atol=TOL, rtol=TOL, err_msg=kind)


def test_bridge_refuses_a_wrong_tree():
    """A missing embedding raises KeyError; an attention kernel split into
    other heads raises ValueError; nothing is written either way."""
    _, variables, model, _ = common.pair("transformer")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(variables["params"])
    params.pop("tok_emb")
    with pytest.raises(KeyError, match="tok_emb/embedding"):
        load_vct_variables(model, {**variables, "params": params})
    params = dict(variables["params"])
    block = dict(params["dec_0"])
    attn = dict(block["cross_attn"])
    q = dict(attn["query"])
    q["kernel"] = q["kernel"].reshape(16, 4, 4)
    attn["query"], block["cross_attn"], params["dec_0"] = q, attn, block
    with pytest.raises(ValueError, match="cross_attn/query"):
        load_vct_variables(model, {**variables, "params": params})
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("kind", ["s2vt", "transformer"])
def test_dropout_acts_in_training_only_from_the_trainers_generator(kind):
    """Eval mode is deterministic; train mode draws its masks (the S2VT
    embeddings', the transformer's attention weights and MLP's) from the
    trainer's generator, so one seed gives one forward."""
    _, cfg = common.configs(kind, dropout=0.3)
    trainer = CaptionTrainer(cfg, common.vocab(), device="cpu")
    videos, captions = map(torch.from_numpy, common.inputs())
    model = trainer.model
    with torch.no_grad():
        a, b = model(videos, captions), model(videos, captions)
        assert torch.equal(a, b)
        outs = []
        for _ in range(2):
            state = trainer.init_state()
            assert all(m.generator is state.generator for m in model.modules()
                       if isinstance(m, Dropout))
            model.train()
            outs.append((model(videos, captions), model(videos, captions)))
        model.eval()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[0][1]) and not torch.equal(outs[0][0], a)


def test_backbone_stays_frozen_at_running_statistics():
    """The trainer trains everything but the backbone (vct's set_to_zero):
    after a step its parameters and BatchNorm statistics are unchanged and
    it has no gradient, while the projection fc moved."""
    _, cfg = common.configs("s2vt")
    trainer = CaptionTrainer(cfg, common.vocab(), device="cpu")
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    assert names and not any(n.startswith("cnn.cnn.") for n in names)
    assert "cnn.fc.weight" in names
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    state = trainer.init_state()
    videos, captions = common.inputs()
    trainer._train_step(state, *trainer._put_batch(videos, captions, np.ones(common.B)))
    after = trainer.model.state_dict()
    for k, v in after.items():
        if k.startswith("cnn.cnn."):
            assert torch.equal(v, before[k]), k
    assert all(p.grad is None for n, p in trainer.model.named_parameters()
               if n.startswith("cnn.cnn."))
    assert not torch.equal(after["cnn.fc.weight"], before["cnn.fc.weight"])


def test_unknown_kind_and_the_card_by_default(monkeypatch):
    import dataclasses

    _, cfg = common.configs("s2vt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KeyError, match="available: s2vt, transformer"):
        build_captioner(dataclasses.replace(cfg, model_kind="lstm"), 11, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_captioner(cfg, 11)
