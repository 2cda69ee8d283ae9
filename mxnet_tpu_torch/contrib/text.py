"""Text utilities (counterpart of ``mxnet_tpu/contrib/text.py``; ref:
python/mxnet/contrib/text/{vocab,embedding}.py).

Vocabulary maps tokens↔indices with reserved tokens and a frequency cutoff;
embedding loads pretrained vectors from a token-per-line text file into an
index-aligned matrix for nn.Embedding initialization. Host-side numpy,
as in the JAX package.
"""
from __future__ import annotations

import collections

import numpy as np

__all__ = ["Vocabulary", "CustomEmbedding", "count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """(ref: contrib/text/utils.py:count_tokens_from_str)."""
    if to_lower:
        source_str = source_str.lower()
    tokens = source_str.replace(seq_delim, token_delim).split(token_delim)
    tokens = [t for t in tokens if t]
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(tokens)
    return counter


class Vocabulary:
    """Token↔index mapping (ref: contrib/text/vocab.py:Vocabulary).

    Index 0 is the unknown token; ``reserved_tokens`` follow; then counted
    tokens by descending frequency (ties broken lexically), subject to
    ``most_freq_count`` and ``min_freq``."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise ValueError("unknown_token must not be in reserved_tokens")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise ValueError("reserved_tokens must not repeat")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            taken = 0
            for tok, freq in pairs:
                if freq < min_freq:
                    break
                if tok == unknown_token or tok in reserved_tokens:
                    continue  # already indexed; must not consume cap slots
                if most_freq_count is not None and taken >= most_freq_count:
                    break
                self._idx_to_token.append(tok)
                taken += 1
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) → index(es); unknown tokens map to index 0."""
        if isinstance(tokens, str):
            return self._token_to_idx.get(tokens, 0)
        return [self._token_to_idx.get(t, 0) for t in tokens]

    def to_tokens(self, indices):
        if isinstance(indices, int):
            indices = [indices]
            single = True
        else:
            single = False
        out = []
        for i in indices:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("index %d out of vocabulary range" % i)
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class CustomEmbedding:
    """Pretrained embedding from a text file of 'token v1 v2 ...' lines
    (ref: contrib/text/embedding.py:CustomEmbedding). After construction,
    ``idx_to_vec`` is an index-aligned (len(vocab), dim) float32 matrix —
    feed it to nn.Embedding's weight."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 vocabulary=None):
        vectors = {}
        dim = None
        with open(pretrained_file_path) as f:
            for lineno, line in enumerate(f, 1):
                parts = line.rstrip("\n").split(elem_delim)
                if len(parts) < 2:
                    continue
                tok, vals = parts[0], parts[1:]
                vec = np.asarray(vals, np.float32)
                if dim is None:
                    dim = vec.size
                elif vec.size != dim:
                    raise ValueError(
                        "%s:%d: vector dim %d != %d"
                        % (pretrained_file_path, lineno, vec.size, dim))
                vectors[tok] = vec
        if dim is None:
            raise ValueError("no vectors found in %s" % pretrained_file_path)
        self.vec_len = dim
        self._vectors = vectors
        if vocabulary is not None:
            self.attach_vocabulary(vocabulary)
        else:
            self._vocab = None
            self.idx_to_vec = None

    def attach_vocabulary(self, vocab):
        mat = np.zeros((len(vocab), self.vec_len), np.float32)
        for i, tok in enumerate(vocab.idx_to_token):
            if tok in self._vectors:
                mat[i] = self._vectors[tok]
        self._vocab = vocab
        self.idx_to_vec = mat
        return mat

    def get_vecs_by_tokens(self, tokens):
        if isinstance(tokens, str):
            # single token → 1-D vector, like the reference API
            return self._vectors.get(tokens,
                                     np.zeros(self.vec_len, np.float32))
        return np.stack([self._vectors.get(
            t, np.zeros(self.vec_len, np.float32)) for t in tokens])
