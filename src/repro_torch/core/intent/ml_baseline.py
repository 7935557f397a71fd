"""Traditional-ML baseline (Table II: XGBoost row).

A from-scratch numpy gradient-boosted-trees classifier (xgboost is not
installed offline) evaluated leave-one-out over the 23-workload matrix —
the paper's "historical execution traces" regime: the model trains on the
other 22 workloads' runtime statistics and predicts the held-out one.
One-vs-rest boosted regression trees (depth 2, logistic loss).

A copy of ``repro.core.intent.ml_baseline``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.intent.probe import RuntimeStats, run_probe
from repro_torch.core.layouts import LayoutMode


def featurize(rs: RuntimeStats, n_nodes: int) -> np.ndarray:
    """Runtime stats → the fixed feature vector of the ML baseline."""
    tot_ops = max(1, rs.posix_reads + rs.posix_writes + rs.posix_meta_ops)
    return np.array([
        rs.read_ratio,
        rs.meta_share,
        np.log10(1 + rs.posix_bytes_written),
        np.log10(1 + rs.posix_bytes_read),
        np.log2(1 + rs.dominant_req_kib),
        rs.posix_seq_ratio,
        rs.shared_file_ops / tot_ops,
        rs.cross_rank_ops / tot_ops,
        float(rs.n_phases),
        rs.meta_mix.get("create", 0.0),
        rs.meta_mix.get("stat", 0.0),
        rs.meta_mix.get("remove", 0.0),
        float(n_nodes),
    ])


# ---------------------------------------------------------------------------
# minimal GBDT (depth-2 regression trees on logistic gradients)
# ---------------------------------------------------------------------------
@dataclass
class _Node:
    feat: int = -1
    thr: float = 0.0
    left: "._Node" = None
    right: "._Node" = None
    value: float = 0.0


def _fit_tree(X, g, h, depth, lam=1.0):
    n, d = X.shape
    if depth == 0 or n < 4:
        return _Node(value=-g.sum() / (h.sum() + lam))
    best = None
    base = (g.sum() ** 2) / (h.sum() + lam)
    for f in range(d):
        order = np.argsort(X[:, f])
        xs, gs, hs = X[order, f], g[order], h[order]
        gl, hl = np.cumsum(gs)[:-1], np.cumsum(hs)[:-1]
        gr, hr = g.sum() - gl, h.sum() - hl
        gain = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) - base
        valid = xs[:-1] != xs[1:]
        gain = np.where(valid, gain, -np.inf)
        i = int(np.argmax(gain))
        if gain[i] > 1e-6 and (best is None or gain[i] > best[0]):
            best = (gain[i], f, (xs[i] + xs[i + 1]) / 2)
    if best is None:
        return _Node(value=-g.sum() / (h.sum() + lam))
    _, f, thr = best
    mask = X[:, f] <= thr
    return _Node(feat=f, thr=thr,
                 left=_fit_tree(X[mask], g[mask], h[mask], depth - 1, lam),
                 right=_fit_tree(X[~mask], g[~mask], h[~mask], depth - 1, lam))


def _predict_tree(node: _Node, x: np.ndarray) -> float:
    while node.feat >= 0:
        node = node.left if x[node.feat] <= node.thr else node.right
    return node.value


class GBDTClassifier:
    """One-vs-rest gradient boosting with logistic loss."""

    def __init__(self, n_rounds: int = 60, lr: float = 0.2, depth: int = 3):
        self.n_rounds, self.lr, self.depth = n_rounds, lr, depth
        self.classes_: List[int] = []
        self.trees_: List[List[_Node]] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTClassifier":
        """One-vs-rest boosted stumps on (features, mode labels)."""
        self.classes_ = sorted(set(int(v) for v in y))
        self.trees_ = []
        for c in self.classes_:
            t = (y == c).astype(np.float64)
            pred = np.zeros(len(y))
            trees = []
            for _ in range(self.n_rounds):
                p = 1.0 / (1.0 + np.exp(-pred))
                g = p - t
                h = np.maximum(p * (1 - p), 1e-6)
                tree = _fit_tree(X, g, h, self.depth)
                trees.append(tree)
                pred += self.lr * np.array(
                    [_predict_tree(tree, x) for x in X])
            self.trees_.append(trees)
        return self

    def predict(self, x: np.ndarray) -> int:
        """Highest-scoring class for one feature vector."""
        scores = []
        for trees in self.trees_:
            scores.append(self.lr * sum(_predict_tree(t, x) for t in trees))
        return self.classes_[int(np.argmax(scores))]


def loo_accuracy(n_nodes: int = 32, seed: int = 0,
                 train_scales: Tuple[int, ...] = (8, 16, 32),
                 ) -> Tuple[float, List[Tuple[str, int, int]]]:
    """Leave-one-workload-out accuracy of the GBDT baseline vs the oracle.

    Mirrors the paper's ML regime: the model trains on historical execution
    traces of the *other* workloads across multiple scales (node counts
    8/16/32 per §IV-A), then predicts the held-out workload at ``n_nodes``.
    """
    from repro_torch.core.intent.oracle import oracle_mode
    from repro_torch.core.workloads import build_workloads

    # training pool: every workload at every scale (+probe-seed jitter)
    pool_X, pool_y, pool_name = [], [], []
    for sc in train_scales:
        for w in build_workloads(sc):
            lbl = int(oracle_mode(w))
            for s in (seed, seed + 1):
                pool_X.append(featurize(run_probe(w, seed=s), w.n_nodes))
                pool_y.append(lbl)
                pool_name.append(w.name)
    pool_X = np.stack(pool_X)
    pool_y = np.array(pool_y)
    pool_name = np.array(pool_name)

    ws = build_workloads(n_nodes)
    results = []
    hits = 0
    for w in ws:
        mask = pool_name != w.name
        clf = GBDTClassifier().fit(pool_X[mask], pool_y[mask])
        x = featurize(run_probe(w, seed=seed + 7), w.n_nodes)
        pred = clf.predict(x)
        truth = int(oracle_mode(w))
        hits += int(pred == truth)
        results.append((w.name, pred, truth))
    return hits / len(ws), results
