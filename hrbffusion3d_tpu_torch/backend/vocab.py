"""Hierarchical binary vocabulary tree + inverted index (port of
``hrbffusion3d_tpu/backend/vocab.py``).

DBoW2's TemplatedVocabulary / TemplatedDatabase: a K-ary tree of depth L
over binary descriptors built by k-majority clustering (the centroid of a
set of binary descriptors is their bitwise majority), tf-idf word weights,
L1-normalised bow vectors, and an inverted file so a query scores only the
entries sharing a word.  Training is host numpy (a copy of the JAX
module's); quantisation is a batched tree walk on torch tensors (L x K
popcount comparisons per descriptor, all descriptors at once), with
first-index ties as ``jnp.argmin`` breaks them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import device_or_card
from .features import hamming

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return _POPCNT8[x.view(np.uint8)].reshape(*x.shape, 4).sum(-1).sum(-1)


def _kmajority(desc: np.ndarray, k: int, seed: int, iters: int = 8):
    """Binary k-means over (N,8)u32 packed descriptors: assign by Hamming
    distance, re-centre by bitwise majority.  Returns (k,8)u32 centroids."""
    rng = np.random.default_rng(seed)
    n = desc.shape[0]
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = desc
        if n:
            out[n:] = desc[rng.integers(0, n, k - n)]
        return out
    cent = desc[rng.choice(n, k, replace=False)].copy()
    bits = np.unpackbits(np.ascontiguousarray(desc).view(np.uint8), axis=-1)      # (N,256)
    for _ in range(iters):
        d = _POPCNT8[(desc[:, None, :] ^ cent[None, :, :]).view(np.uint8)].reshape(n, k, -1).sum(-1)
        assign = d.argmin(-1)
        new = np.zeros_like(cent)
        for j in range(k):
            sel = assign == j
            if not sel.any():
                new[j] = desc[rng.integers(0, n)]
                continue
            maj = (bits[sel].mean(0) >= 0.5).astype(np.uint8)
            new[j] = np.packbits(maj).view(np.uint32)
        if (new == cent).all():
            break
        cent = new
    return cent


class VocabularyTree:
    """K-ary depth-L binary vocabulary with tf-idf weights; centroids and
    weights live on ``device`` (None: the CUDA card)."""

    def __init__(self, centroids: list[np.ndarray], idf: np.ndarray, k: int, depth: int,
                 device=None):
        # centroids[l]: (K^l * K, 8) — children of every level-l node,
        # stored node-major so node i's children are rows [i*K, (i+1)*K)
        device = device_or_card(device)
        self.centroids = [torch.from_numpy(np.asarray(c, np.uint32).astype(np.int64)).to(device)
                          for c in centroids]
        self.idf = torch.from_numpy(np.asarray(idf, np.float32)).to(device)
        self.k = k
        self.depth = depth
        self.n_words = k ** depth

    # ------------------------------------------------------------------ #
    @staticmethod
    def train(desc: np.ndarray, k: int = 10, depth: int = 3, seed: int = 7,
              device=None) -> "VocabularyTree":
        """Hierarchical k-majority (TemplatedVocabulary::create) on the host.
        ``desc``: (N,8)u32 training descriptors."""
        desc = np.ascontiguousarray(np.asarray(desc, np.uint32))
        groups = [np.arange(desc.shape[0])]
        centroids = []
        for lvl in range(depth):
            cents = np.zeros((len(groups) * k, 8), np.uint32)
            nxt: list[np.ndarray] = []
            for g, idx in enumerate(groups):
                c = _kmajority(desc[idx], k, seed + 131 * lvl + g)
                cents[g * k:(g + 1) * k] = c
                if idx.size:
                    d = _POPCNT8[(desc[idx][:, None, :] ^ c[None, :, :]).view(np.uint8)
                                 ].reshape(idx.size, k, -1).sum(-1)
                    a = d.argmin(-1)
                else:
                    a = np.zeros((0,), int)
                for j in range(k):
                    nxt.append(idx[a == j])
            centroids.append(cents)
            groups = nxt
        # idf from the training set (TemplatedVocabulary::setNodeWeights):
        # weight_w = log(N / n_w), the document being the descriptor itself
        counts = np.array([g.size for g in groups], np.float64)
        n = max(desc.shape[0], 1)
        idf = np.log(n / np.maximum(counts, 1.0)).astype(np.float32)
        return VocabularyTree(centroids, idf, k, depth, device)

    # ------------------------------------------------------------------ #
    def quantize(self, desc: torch.Tensor) -> torch.Tensor:
        """(N,8) int64 words -> (N,) int64 leaf word ids (batched descent)."""
        desc = desc.to(self.idf.device)
        node = torch.zeros((desc.shape[0],), dtype=torch.int64, device=desc.device)
        ar = torch.arange(self.k, device=desc.device)
        for cents in self.centroids:                      # (nodes*K, 8)
            base = node * self.k
            cand = cents[base[:, None] + ar[None]]        # (N,K,8)
            d = hamming(desc[:, None, :], cand)
            node = base + torch.argmin(d, dim=-1)
        return node

    def bow_vector(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """tf-idf, L1-normalised (W,) vector (BowVector::addWeight +
        normalize(L1))."""
        word = self.quantize(desc)
        hist = torch.zeros((self.n_words,), dtype=torch.float32, device=word.device).index_add_(
            0, word, valid.to(word.device, torch.float32))
        v = hist * self.idf
        return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


class InvertedIndex:
    """TemplatedDatabase equivalent: word -> [(entry, value)] lists; a query
    touches only entries sharing a word, scoring the same DBoW2 L1 metric
    s = sum_w min(v_w, u_w) as the dense path."""

    def __init__(self, n_words: int):
        self.n_words = n_words
        self.words: list[list[tuple[int, float]]] = [[] for _ in range(n_words)]
        self.n_entries = 0

    def add(self, vec: np.ndarray) -> int:
        eid = self.n_entries
        self.n_entries += 1
        for w in np.nonzero(vec)[0]:
            self.words[int(w)].append((eid, float(vec[w])))
        return eid

    def query(self, vec: np.ndarray, exclude=()) -> np.ndarray:
        """Scores vs all entries (dense (n_entries,) output; accumulation is
        sparse over shared words)."""
        scores = np.zeros((self.n_entries,), np.float32)
        for w in np.nonzero(vec)[0]:
            vw = float(vec[w])
            for eid, uw in self.words[int(w)]:
                scores[eid] += min(vw, uw)
        for e in exclude:
            if 0 <= e < self.n_entries:
                scores[e] = -1.0
        return scores
