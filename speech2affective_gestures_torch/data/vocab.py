"""Word vocabulary (reference `utils/vocab.py`): PAD/SOS/EOS/UNK tokens,
word indexing and the UNK fallback the synthesis path reads."""

from __future__ import annotations


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self.trimmed = False
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


def placeholder_vocab(n_words: int) -> Vocab:
    """A vocabulary of exactly `n_words` entries: the four special tokens
    plus placeholders `<w4>`, `<w5>`, ... Used where no dataset provides
    the real word list; every real word then maps to <UNK>."""
    vocab = Vocab("words")
    while vocab.n_words < n_words:
        vocab.index_word(f"<w{vocab.n_words}>")
    return vocab
