"""Bag-of-binary-words place recognition (port of
``hrbffusion3d_tpu/backend/bow.py``).

DBoW2's role (``Core/src/ORB_SLAM2_m/Thirdparty/DBoW2``): binary
descriptors are quantised against a deterministic random vocabulary,
histograms are L1-normalised, and the DBoW2 L1 score
s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1 (BowVector::score) is computed for all
database entries in one batched min-sum.  Descriptors are the 32-bit words
in ``int64`` of ``features``; the histograms are counts, so their sums are
exact in any order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .features import hamming


@functools.lru_cache()
def vocabulary(n_words: int = 512, seed: int = 11) -> np.ndarray:
    """(W, 8) uint32 random binary centroid descriptors (host numpy)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n_words, 8), dtype=np.uint32)


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, n_words: int = 512) -> torch.Tensor:
    """Quantise (N,8) packed descriptors -> L1-normalised (W,) histogram."""
    vocab = torch.from_numpy(vocabulary(n_words).astype(np.int64)).to(desc.device)
    dist = hamming(desc[:, None, :], vocab[None, :, :])
    dist = torch.where(valid[:, None], dist, 1 << 20)
    word = torch.argmin(dist, dim=-1)
    hist = torch.zeros((n_words,), dtype=torch.float32, device=desc.device).index_add_(
        0, word, valid.to(torch.float32))
    return hist / torch.clamp(torch.sum(hist), min=1e-12)


def l1_score(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of one vector against a database (K, W):
    s = 1 - 0.5 |v - w|_1 = sum_i min(v_i, w_i) in [0, 1] for L1-normalised
    vectors."""
    return torch.sum(torch.minimum(v[None, :], db), dim=-1)


class BowDatabase:
    """KeyFrameDatabase equivalent with two backends: the flat random
    vocabulary with dense batched min-sum scoring (default), or a trained
    ``vocab.VocabularyTree`` with a true inverted index (DBoW2
    TemplatedDatabase semantics).  Vectors are kept on the host."""

    def __init__(self, n_words: int = 512, tree=None):
        self.tree = tree
        self.n_words = tree.n_words if tree is not None else n_words
        self.vectors: list[np.ndarray] = []
        if tree is not None:
            from .vocab import InvertedIndex

            self.index = InvertedIndex(self.n_words)
        else:
            self.index = None

    def add(self, desc: torch.Tensor, valid: torch.Tensor) -> int:
        if self.tree is not None:
            v = self.tree.bow_vector(desc, valid)
        else:
            v = bow_vector(desc, valid, self.n_words)
        v = v.cpu().numpy()
        self.vectors.append(v)
        if self.index is not None:
            self.index.add(v)
        return len(self.vectors) - 1

    def query(self, idx: int, exclude=()):
        """Scores of entry ``idx`` against all earlier entries.  ``exclude``
        (the query's covisible set, LoopClosing.cc:209) are forced to -1."""
        if idx < 1:
            return np.zeros((0,))
        if self.index is not None:
            scores = self.index.query(self.vectors[idx])[:idx]
        else:
            db = np.stack(self.vectors[:idx])
            scores = l1_score(torch.from_numpy(self.vectors[idx]), torch.from_numpy(db)).numpy()
        for k in exclude:
            if 0 <= k < idx:
                scores[k] = -1.0
        return scores
