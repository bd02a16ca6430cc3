"""Evaluation metrics — the port of ``snd_vae_tpu/evaluate.py``, function for
function and with the same metric keys:

  * ``reconstruct_evaluation`` — edge AUC/AP, edge accuracy/P/R/F1, node
    MSE (or scene's node accuracy), coordinate MSE, scene's relation
    accuracy;
  * ``generation_evaluation`` — Gaussian-kernel MMDs of degree, clustering,
    edge-length and Laplacian-spectrum histograms of generated against data
    graphs, and both edge densities;
  * ``disentangle_evaluation`` — per-branch max |correlation| per factor, a
    MIG-style gap, SAP and DCI.

Host-side numpy, as in JAX: these run once per evaluation.  Where the JAX
package calls scikit-learn, this module has its own numpy version:

  * ``roc_auc`` and ``average_precision`` compute what sklearn's
    ``roc_auc_score`` and ``average_precision_score`` compute, from the same
    binary classification curve: one point per distinct score (tied scores
    collapse into one threshold), the AUC the trapezoid sum under the ROC
    points (for ties, the Mann-Whitney average rank), the AP the step sum
    Σ (R_n − R_{n−1})·P_n over the thresholds in decreasing order;
  * ``lasso`` is sklearn's ``Lasso(alpha, max_iter, tol)`` with
    ``fit_intercept=True``: cyclic coordinate descent on
    (1/2n)·‖y − Xw − b‖² + α·‖w‖₁ with sklearn's gap-safe screening and its
    stopping rule (after a sweep with max|Δw| / max|w| ≤ tol, stop once the
    duality gap is at most tol·‖y‖²), so its coefficients follow sklearn's
    iterate for iterate.  DCI's importances always come from it; the JAX
    package's |corr| fallback for a missing sklearn has no counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Ranking metrics (sklearn.metrics' roc_auc_score / average_precision_score)
# ---------------------------------------------------------------------------

def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative true and false positives at each distinct score, from the
    highest down (sklearn's ``_binary_clf_curve``)."""
    y_true = np.asarray(y_true).reshape(-1).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64).reshape(-1)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    # the last index of each run of tied scores, and the end
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    fps = 1.0 + last - tps
    return tps, fps


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve; needs both classes present."""
    tps, fps = _binary_clf_curve(y_true, y_score)
    tpr = np.r_[0.0, tps] / tps[-1]
    fpr = np.r_[0.0, fps] / fps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Σ_n (R_n − R_{n−1})·P_n over the distinct thresholds, R_0 = 0."""
    tps, fps = _binary_clf_curve(y_true, y_score)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


# ---------------------------------------------------------------------------
# Reconstruction metrics
# ---------------------------------------------------------------------------

def _off_diag(a: np.ndarray) -> np.ndarray:
    n = a.shape[-1]
    mask = ~np.eye(n, dtype=bool)
    return a[..., mask]


def edge_presence_scores(adj_prob) -> np.ndarray:
    """P(edge present) = 1 − softmax(logits)[..., 0] from the decoder's
    [..., N, N, C] edge-class logits (any array or CPU tensor), in float64 so
    that bf16 runs do not quantize the AUC/AP ranking."""
    logits = np.asarray(adj_prob, dtype=np.float64)
    logits = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(logits)
    return 1.0 - e[..., 0] / e.sum(-1)


def reconstruct_evaluation(
    gen_adj: np.ndarray,
    gen_nodes: np.ndarray,
    gen_spatial: np.ndarray,
    adj_truth: np.ndarray,
    feature_truth: np.ndarray,
    spatial_truth: np.ndarray,
    dataset: str = "",
    adj_scores: Optional[np.ndarray] = None,
    node_categorical: Optional[bool] = None,
) -> Dict[str, float]:
    """Edge, node and coordinate scores of decoded graphs against the truth.
    ``adj_scores`` ranks the edges for AUC/AP (else the hard decode does);
    ``node_categorical`` says the node decode holds class indices (scene),
    scored by accuracy; None guesses it from the sizes."""
    G = min(len(gen_adj), len(adj_truth))
    y_true = _off_diag(np.asarray(adj_truth[:G])).reshape(-1) > 0.5
    if adj_scores is not None:
        y_score = _off_diag(np.asarray(adj_scores[:G])).reshape(-1)
    else:
        y_score = _off_diag(np.asarray(gen_adj[:G], dtype=np.float64)).reshape(-1)
    y_pred = _off_diag(np.asarray(gen_adj[:G])).reshape(-1) > 0.5

    out: Dict[str, float] = {}
    if y_true.any() and not y_true.all():
        out["edge_auc"] = roc_auc(y_true, y_score)
        out["edge_ap"] = average_precision(y_true, y_score)
    tp = float(np.sum(y_pred & y_true))
    fp = float(np.sum(y_pred & ~y_true))
    fn = float(np.sum(~y_pred & y_true))
    out["edge_acc"] = float(np.mean(y_pred == y_true))
    out["edge_precision"] = tp / max(tp + fp, 1.0)
    out["edge_recall"] = tp / max(tp + fn, 1.0)
    p, r = out["edge_precision"], out["edge_recall"]
    out["edge_f1"] = 2 * p * r / max(p + r, 1e-12)
    gn = np.asarray(gen_nodes[:G])
    ft = np.asarray(feature_truth[:G])
    if node_categorical is None:
        node_categorical = gn.size != ft.size
    if not node_categorical:
        out["node_mse"] = float(np.mean((gn - ft.reshape(gn.shape)) ** 2))
    else:
        # class indices [G,N(,1)] against one-hot truth [G,N,K]
        idx_true = np.argmax(ft, axis=-1)
        out["node_acc"] = float(np.mean(gn.reshape(idx_true.shape) == idx_true))
    out["spatial_mse"] = float(
        np.mean((np.asarray(gen_spatial[:G]) - np.asarray(spatial_truth[:G])) ** 2)
    )
    at = np.asarray(adj_truth[:G])
    ga = np.asarray(gen_adj[:G])
    if at.max() > 1 or ga.max() > 1:
        # K-way relations (scene): exact relation-type accuracy off the diagonal
        out["relation_acc"] = float(np.mean(_off_diag(ga) == _off_diag(at)))
    return out


# ---------------------------------------------------------------------------
# Generation metrics (graph-statistic MMDs)
# ---------------------------------------------------------------------------

def _sym(adj: np.ndarray) -> np.ndarray:
    """Binarized, symmetrized adjacency (graph statistics are undirected;
    scene's decodes are directed)."""
    a = (adj > 0.5).astype(np.float64)
    return np.maximum(a, np.swapaxes(a, -1, -2))


def _degree_hist(adj: np.ndarray, bins: int) -> np.ndarray:
    deg = _sym(adj).sum(-1)
    h, _ = np.histogram(deg, bins=bins, range=(0, bins), density=True)
    return h


def _safe_hist(vals: np.ndarray, bins: int, range_) -> np.ndarray:
    """Normalized histogram, zeros where no sample falls inside ``range_``."""
    h, edges = np.histogram(vals, bins=bins, range=range_)
    total = h.sum()
    if total == 0:
        return np.zeros(bins)
    return h / (total * (edges[1] - edges[0]))


def _clustering_coeffs(adj: np.ndarray) -> np.ndarray:
    """Per-node clustering coefficients of the symmetrized graph."""
    a = _sym(adj)
    deg = a.sum(-1)
    tri = np.diagonal(a @ a @ a)  # 2x triangles per node
    denom = deg * (deg - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0, tri / denom, 0.0)
    return c


def _spectral_hist(adj: np.ndarray, bins: int = 10) -> np.ndarray:
    """Eigenvalue histogram of the symmetric normalized Laplacian
    I − D^-1/2 A D^-1/2 over [0, 2]."""
    a = _sym(adj)
    deg = a.sum(-1)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg**-0.5, 0.0)
    lap = np.eye(a.shape[0]) - dinv[:, None] * a * dinv[None, :]
    ev = np.linalg.eigvalsh(lap)
    h, _ = np.histogram(ev, bins=bins, range=(0.0, 2.0), density=True)
    return h


def _edge_lengths(adj: np.ndarray, coords: np.ndarray) -> np.ndarray:
    i, j = np.nonzero(np.triu(_sym(adj), 1))
    if len(i) == 0:
        return np.zeros(1)
    return np.linalg.norm(coords[i] - coords[j], axis=-1)


def gaussian_mmd(x: np.ndarray, y: np.ndarray, sigma: float = 1.0) -> float:
    """MMD² with a Gaussian kernel between two sets of descriptor vectors."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * sigma**2))

    return float(k(x, x).mean() + k(y, y).mean() - 2 * k(x, y).mean())


def generation_evaluation(
    gen_adj: np.ndarray,
    gen_nodes: np.ndarray,
    gen_spatial: np.ndarray,
    adj: np.ndarray,
    feature: np.ndarray,
    spatial: np.ndarray,
    dataset: str = "",
) -> Dict[str, float]:
    """Generated graphs against data graphs: four histogram MMDs and both
    edge densities."""
    gen_adj = np.asarray(gen_adj)
    adj = np.asarray(adj)
    if adj.ndim == 4:  # [G,S,N,N] spanning-tree samples -> the originals
        adj = adj[:, 0]
    n = gen_adj.shape[-1]
    bins = n

    deg_g = np.stack([_degree_hist(a, bins) for a in gen_adj])
    deg_r = np.stack([_degree_hist(a, bins) for a in adj])
    clus_g = np.stack([_safe_hist(_clustering_coeffs(a), 10, (0, 1)) for a in gen_adj])
    clus_r = np.stack([_safe_hist(_clustering_coeffs(a), 10, (0, 1)) for a in adj])
    G = min(len(gen_adj), len(gen_spatial))
    Gr = min(len(adj), len(spatial))
    spatial = np.asarray(spatial)
    gen_spatial = np.asarray(gen_spatial)
    # edge-length range: sqrt(D) for unit-box coordinates, else the
    # reference graphs' longest edge (raw protein / mnist scales)
    ref_lengths = [_edge_lengths(adj[i], spatial[i]) for i in range(Gr)]
    el_hi = max(
        float(np.sqrt(spatial.shape[-1])),
        max((float(l.max()) for l in ref_lengths), default=0.0),
    )
    el_g = np.stack([
        _safe_hist(np.minimum(_edge_lengths(gen_adj[i], gen_spatial[i]), el_hi),
                   10, (0, el_hi))
        for i in range(G)
    ])
    el_r = np.stack([_safe_hist(l, 10, (0, el_hi)) for l in ref_lengths])

    spec_g = np.stack([_spectral_hist(a) for a in gen_adj])
    spec_r = np.stack([_spectral_hist(a) for a in adj])

    return {
        "degree_mmd": gaussian_mmd(deg_g, deg_r),
        "clustering_mmd": gaussian_mmd(clus_g, clus_r),
        "edge_length_mmd": gaussian_mmd(el_g, el_r),
        "spectral_mmd": gaussian_mmd(spec_g, spec_r),
        "density_gen": float((_off_diag(gen_adj) > 0.5).mean()),
        "density_ref": float((_off_diag(adj) > 0.5).mean()),
    }


# ---------------------------------------------------------------------------
# Disentanglement metrics
# ---------------------------------------------------------------------------

def _abs_corr(z: np.ndarray, f: np.ndarray) -> np.ndarray:
    """|Pearson correlation| between latent dims and factors, [L, K]."""
    z = np.asarray(z, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    zc = z - z.mean(0)
    fc = f - f.mean(0)
    zs = zc.std(0) + 1e-12
    fs = fc.std(0) + 1e-12
    return np.abs((zc / zs).T @ (fc / fs)) / len(z)


def disentangle_evaluation(
    z_s: np.ndarray,
    z_g: np.ndarray,
    z_sg: np.ndarray,
    factor: np.ndarray,
    dataset: str = "",
) -> Dict[str, float]:
    """Per factor, each branch's strongest correlating latent dimension; a
    MIG-style gap (top-1 minus top-2, normalized) over all latents; SAP and
    DCI."""
    reshape2 = lambda z: np.asarray(z).reshape(-1, np.asarray(z).shape[-1])
    z_s, z_g, z_sg = reshape2(z_s), reshape2(z_g), reshape2(z_sg)
    factor = np.asarray(factor, dtype=np.float64)
    if factor.ndim == 1:
        factor = factor[:, None]
    n = min(len(z_s), len(z_g), len(z_sg), len(factor))
    z_s, z_g, z_sg, factor = z_s[:n], z_g[:n], z_sg[:n], factor[:n]

    out: Dict[str, float] = {}
    for name, z in (("s", z_s), ("g", z_g), ("sg", z_sg)):
        c = _abs_corr(z, factor)  # [L, K]
        for k in range(factor.shape[1]):
            out[f"{name}_factor{k}_maxcorr"] = float(c[:, k].max())

    z_all = np.concatenate([z_s, z_g, z_sg], axis=1)
    c_all = _abs_corr(z_all, factor)
    gaps = []
    for k in range(factor.shape[1]):
        top = np.sort(c_all[:, k])[::-1]
        if len(top) >= 2 and top[0] > 0:
            gaps.append((top[0] - top[1]) / top[0])
    out["mig_gap"] = float(np.mean(gaps)) if gaps else 0.0
    out["sap"] = sap_score(z_all, factor)
    out.update(dci_scores(z_all, factor))
    return out


def sap_score(z: np.ndarray, factors: np.ndarray) -> float:
    """Separated Attribute Predictability: the mean over factors of the gap
    between the top two single-latent R² (squared correlations)."""
    z = np.asarray(z, dtype=np.float64).reshape(len(z), -1)
    f = _varying_factors(factors)
    s = _abs_corr(z, f) ** 2  # [L, K] single-latent R²
    if s.shape[0] < 2 or s.shape[1] == 0:
        return 0.0
    gaps = []
    for k in range(s.shape[1]):
        top = np.sort(s[:, k])[::-1]
        gaps.append(top[0] - top[1])
    return float(np.mean(gaps))


def _entropy(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def _varying_factors(factors: np.ndarray) -> np.ndarray:
    """[n, K'] factors with the constant columns dropped."""
    f = np.asarray(factors, dtype=np.float64)
    if f.ndim == 1:
        f = f[:, None]
    return f[:, f.std(0) > 1e-12]


def lasso(X: np.ndarray, y: np.ndarray, alpha: float, max_iter: int = 1000,
          tol: float = 1e-4) -> np.ndarray:
    """Coefficients of sklearn's ``Lasso(alpha, max_iter=max_iter, tol=tol)``
    fitted to (X, y) with an intercept (see the module docstring).  X and y
    are centred first, so the intercept drops out; the descent then works
    on (1/2)‖y − Xw‖² + a·‖w‖₁ with a = α·n, as sklearn's does."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    X = X - X.mean(axis=0)
    y = y - y.mean()
    n, p = X.shape
    a = alpha * n
    Xf = np.asfortranarray(X)
    cols = [Xf[:, j] for j in range(p)]
    norm2 = np.einsum("ij,ij->j", X, X)
    w = np.zeros(p)
    R = y.copy()
    gap_tol = tol * float(y @ y)

    def gap():
        XtA = Xf.T @ R
        dual_norm = float(np.max(np.abs(XtA))) if p else 0.0
        r2, ry = float(R @ R), float(R @ y)
        primal = 0.5 * r2 + a * float(np.sum(np.abs(w)))
        scale = a / dual_norm if dual_norm > a else 1.0
        return primal - (-0.5 * scale**2 * r2 + scale * ry), XtA, dual_norm

    def screen(candidates, g, XtA, dual_norm):
        """Gap-safe screening: the features that may be non-zero at the
        optimum; the others are set to 0 and leave the residual."""
        keep = []
        for j in candidates:
            d_j = (1.0 - abs(XtA[j] / max(a, dual_norm))) / np.sqrt(norm2[j])
            if d_j <= np.sqrt(2.0 * g) / a:
                keep.append(j)
            elif w[j] != 0.0:
                R[:] += w[j] * cols[j]
                w[j] = 0.0
        return keep

    g, XtA, dual_norm = gap()
    if g <= gap_tol:
        return w
    active = screen([j for j in range(p) if norm2[j] != 0.0], g, XtA, dual_norm)
    for it in range(max_iter):
        w_max = d_w_max = 0.0
        for j in active:
            w_j = w[j]
            tmp = float(cols[j] @ R) + w_j * norm2[j]
            w[j] = np.sign(tmp) * max(abs(tmp) - a, 0.0) / norm2[j]
            if w[j] != w_j:
                R += (w_j - w[j]) * cols[j]
            d_w_max = max(d_w_max, abs(w[j] - w_j))
            w_max = max(w_max, abs(w[j]))
        if w_max == 0.0 or d_w_max / w_max <= tol or it == max_iter - 1:
            g, XtA, dual_norm = gap()
            if g <= gap_tol:
                break
            active = screen(active, g, XtA, dual_norm)
    return w


def _dci_importance(z: np.ndarray, f: np.ndarray) -> np.ndarray:
    """[L, K] importance of each latent for each factor: |coef| of a Lasso
    (α = 0.02, 5000 iterations) on standardized inputs and factor."""
    zs = (z - z.mean(0)) / (z.std(0) + 1e-12)
    r = np.zeros((z.shape[1], f.shape[1]))
    for k in range(f.shape[1]):
        fk = f[:, k]
        std = fk.std()
        if std < 1e-12:
            continue
        r[:, k] = np.abs(lasso(zs, (fk - fk.mean()) / std, alpha=0.02, max_iter=5000))
    return r


def dci_scores(z: np.ndarray, factors: np.ndarray) -> Dict[str, float]:
    """DCI (Eastwood & Williams 2018) from the importance matrix R:
    disentanglement (1 − normalized entropy of each latent's row, weighted
    by its share of R), completeness (1 − normalized entropy of each
    factor's column, averaged) and informativeness (the mean in-sample R²
    of the least-squares predictor per factor)."""
    z = np.asarray(z, dtype=np.float64).reshape(len(z), -1)
    f = _varying_factors(factors)
    L, K = z.shape[1], f.shape[1]
    out = {"dci_disentanglement": 0.0, "dci_completeness": 0.0,
           "dci_informativeness": 0.0}
    if K == 0:
        return out
    r = _dci_importance(z, f)
    total = r.sum()
    if total <= 0:
        return out

    if K > 1:
        rho = r.sum(1) / total
        d = np.array([
            1.0 - _entropy(r[i] / r[i].sum()) / np.log(K) if r[i].sum() > 0
            else 0.0
            for i in range(L)
        ])
        out["dci_disentanglement"] = float((rho * d).sum())
    else:
        # one factor: every importance row is trivially concentrated
        out["dci_disentanglement"] = 1.0

    if L > 1:
        c = np.array([
            1.0 - _entropy(r[:, k] / r[:, k].sum()) / np.log(L)
            if r[:, k].sum() > 0 else 0.0
            for k in range(K)
        ])
        out["dci_completeness"] = float(c.mean())
    else:
        out["dci_completeness"] = 1.0

    zs = (z - z.mean(0)) / (z.std(0) + 1e-12)
    zb = np.concatenate([zs, np.ones((len(zs), 1))], axis=1)
    r2s = []
    for k in range(K):
        fk = f[:, k]
        var = fk.var()
        if var < 1e-12:
            continue
        coef, *_ = np.linalg.lstsq(zb, fk, rcond=None)
        resid = fk - zb @ coef
        r2s.append(1.0 - resid.var() / var)
    out["dci_informativeness"] = float(np.mean(r2s)) if r2s else 0.0
    return out
