"""IBMIL confounder pipeline: bag features -> PCA-whiten -> k-means
prototypes (reference Survival/models/IBMIL/clustering.py +
Clustering.sh).

Counterpart of `rrtmil_tpu/data/confounders.py`:

* `pca_whiten`: exact PCA by eigendecomposition with faiss-style
  whitening and row normalisation, in numpy (float64);
* `kmeans`: k-means++ seeding drawn from an explicit `torch.Generator`,
  then Lloyd iterations as tensor ops on the generator's device (an empty
  cluster's centroid becomes zero, as in the JAX package);
* `extract_bag_features`: the pooled 512-d embedding of each bag from an
  AB-MIL (`models/abmil.ABMIL`, `return_pooled=True`), each bag padded to
  a power-of-two length with a mask (masked pooling is exact);
* `build_confounders`: the whole flow.  As in the reference, clusters are
  found in the whitened space but the prototypes are the member bags'
  means in the ORIGINAL feature space (clustering.py:107-134).

`python -m rrtmil_tpu_torch.build_confounders` runs it per fold of the
classification CLI's own splits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pca_whiten(x: np.ndarray, dim_out: Optional[int] = None,
               eps: float = 1e-5) -> np.ndarray:
    """PCA with whitening + L2 normalisation (clustering.py:17-47 `reduce`:
    faiss.PCAMatrix(d, d, -0.5), then each row normalised)."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / max(len(x) - 1, 1)
    eigval, eigvec = np.linalg.eigh(cov)
    order = np.argsort(-eigval)
    eigval, eigvec = eigval[order], eigvec[:, order]
    if dim_out is not None:
        eigval, eigvec = eigval[:dim_out], eigvec[:, :dim_out]
    w = eigvec * np.power(np.maximum(eigval, eps), -0.5)[None, :]
    out = xc @ w
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norms, 1e-12)).astype(np.float32)


def kmeans(x, k: int, generator: torch.Generator,
           n_iter: int = 20) -> torch.Tensor:
    """k-means++ seeding + `n_iter` Lloyd iterations on (N, D) -> (k, D)
    float32 centroids, on the device of `generator`, which draws the
    seeding."""
    g = generator
    x = torch.as_tensor(x, dtype=torch.float32, device=g.device)
    n, d = x.shape
    if k > n:
        raise ValueError(f"k-means of {n} points into {k} clusters")
    centroids = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    idx = torch.randint(0, n, (1,), generator=g, device=x.device)
    centroids[0] = x[idx[0]]
    min_d2 = ((x - centroids[0]) ** 2).sum(dim=1)
    for i in range(1, k):
        probs = min_d2 / torch.clamp(min_d2.sum(), min=1e-12)
        idx = torch.multinomial(probs, 1, generator=g)
        centroids[i] = x[idx[0]]
        min_d2 = torch.minimum(min_d2, ((x - centroids[i]) ** 2).sum(dim=1))
    xx = (x * x).sum(dim=1)[:, None]
    for _ in range(n_iter):
        d2 = xx - 2 * x @ centroids.t() + (centroids * centroids).sum(1)[None]
        onehot = torch.nn.functional.one_hot(d2.argmin(dim=1), k).to(x.dtype)
        counts = torch.clamp(onehot.sum(dim=0), min=1.0)
        centroids = (onehot.t() @ x) / counts[:, None]
    return centroids


@torch.no_grad()
def extract_bag_features(model, dataset) -> np.ndarray:
    """(N, 512) pooled bag embeddings of `dataset`'s bags from `model` in
    eval mode, on its device (an `ABMIL`; reference
    Survival/models/IBMIL/clustering.py via Clustering.sh), each bag padded
    to a power-of-two length of at least 64 with its mask."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    feats = []
    try:
        for i in range(len(dataset)):
            bag = np.asarray(dataset[i][0], np.float32)
            if bag.ndim == 3:
                bag = bag[0]
            n = 1 << max(6, (bag.shape[0] - 1).bit_length())
            x = torch.zeros((1, n, bag.shape[1]), dtype=torch.float32)
            x[0, :bag.shape[0]] = torch.from_numpy(bag)
            mask = torch.zeros((1, n), dtype=torch.bool)
            mask[0, :bag.shape[0]] = True
            _, pooled = model(x.to(dev), mask=mask.to(dev),
                              return_pooled=True)
            feats.append(pooled[0].float())
    finally:
        model.train(was_training)
    return torch.stack(feats).cpu().numpy()


def build_confounders(bag_feats: np.ndarray, k: int,
                      generator: torch.Generator) -> np.ndarray:
    """(N, 512) bag features -> (k, 512) float32 prototypes: k-means in the
    whitened space (on `generator`'s device, which seeds it), each
    prototype the mean of its member bags' ORIGINAL features (zero for an
    empty cluster)."""
    bag_feats = np.asarray(bag_feats, np.float32)
    x = pca_whiten(bag_feats)
    centroids = kmeans(x, k, generator).cpu().numpy()
    d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(axis=1)
    protos = np.zeros((k, bag_feats.shape[1]), np.float32)
    for c in range(k):
        members = bag_feats[assign == c]
        protos[c] = members.mean(axis=0) if len(members) else 0.0
    return protos
