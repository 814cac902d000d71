"""Word and speaker vocabularies (reference `utils/vocab.py`,
`utils/vocab_utils.py`): PAD/SOS/EOS/UNK tokens, word indexing, the UNK
fallback, word vectors, and the corpus indexing of the training data."""

from __future__ import annotations

import os
import pickle
from typing import Iterable

import numpy as np


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self.trimmed = False
        self.word_embedding_weights: np.ndarray | None = None
        self.reset_dictionary(insert_default_tokens)

    def reset_dictionary(self, insert_default_tokens: bool = True):
        self.word2index: dict[str, int] = {}
        self.word2count: dict[str, int] = {}
        if insert_default_tokens:
            self.index2word = {
                self.PAD_token: "<PAD>", self.SOS_token: "<SOS>",
                self.EOS_token: "<EOS>", self.UNK_token: "<UNK>",
            }
        else:
            self.index2word = {self.UNK_token: "<UNK>"}
        self.n_words = len(self.index2word)

    def index_word(self, word: str):
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def trim(self, min_count: int):
        """Drop words rarer than min_count (ref utils/vocab.py:42-62)."""
        if self.trimmed:
            return
        self.trimmed = True
        keep = [w for w, c in self.word2count.items() if c >= min_count]
        self.reset_dictionary()
        for word in keep:
            self.index_word(word)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)

    def load_word_vectors(self, pretrained_path: str | None, embedding_dim: int = 300,
                          seed: int = 0):
        """fastText vectors (ref utils/vocab.py:70-84) when the model file
        and the `fasttext` package are there; N(0, 1/sqrt(d)) vectors drawn
        from `seed` otherwise."""
        rng = np.random.default_rng(seed)
        weights = rng.normal(0, 1.0 / np.sqrt(embedding_dim),
                             size=(self.n_words, embedding_dim)).astype(np.float32)
        if pretrained_path and os.path.exists(pretrained_path):
            try:
                import fasttext  # optional dependency
            except ImportError:
                fasttext = None
            if fasttext is not None:
                model = fasttext.load_model(pretrained_path)
                for word, idx in self.word2index.items():
                    weights[idx] = model.get_word_vector(word)
        self.word_embedding_weights = weights


def build_vocab(name: str, word_iterables: Iterable[Iterable[str]],
                cache_path: str | None = None, word_vec_path: str | None = None,
                feat_dim: int | None = None) -> Vocab:
    """Index all words of the iterables, with a pickle cache (ref
    utils/vocab_utils.py:11-35)."""
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    vocab = Vocab(name)
    for words in word_iterables:
        for word in words:
            vocab.index_word(word)
    if feat_dim is not None:
        vocab.load_word_vectors(word_vec_path, feat_dim)
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump(vocab, f)
    return vocab


def make_speaker_vocab(video_ids: Iterable[str]) -> Vocab:
    """The speaker model: a Vocab over video ids without the PAD/SOS/EOS
    tokens, so ids start at 1 (ref loader_v2.py:521-539)."""
    vocab = Vocab("vids", insert_default_tokens=False)
    for vid in video_ids:
        vocab.index_word(vid)
    return vocab


def placeholder_vocab(n_words: int) -> Vocab:
    """A vocabulary of exactly `n_words` entries: the four special tokens
    plus placeholders `<w4>`, `<w5>`, ... Used where no dataset provides
    the real word list; every real word then maps to <UNK>."""
    vocab = Vocab("words")
    while vocab.n_words < n_words:
        vocab.index_word(f"<w{vocab.n_words}>")
    return vocab
