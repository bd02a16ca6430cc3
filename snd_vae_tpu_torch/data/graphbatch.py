"""GraphBatch — a batch of spatial networks as torch tensors, with the fields
of ``snd_vae_tpu/data/graphbatch.py:23-55`` and explicit [B, S, N, ...] axes.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

_FLOAT_FIELDS = ("adj", "features", "coords", "rel", "adj_samples", "node_mask",
                 "feat_samples", "rel_samples")


@dataclass
class GraphBatch:
    """A batch of B spatial networks with N nodes each.

      adj [B,N,N], features [B,N,F], coords [B,N,D], rel [B,N,N,R];
      adj_samples [B,S,N,N] spanning-tree samples or None;
      factors [B,K] ground-truth generative factors or None;
      node_mask [B,N] (1 = real node) or None when nothing is padded;
      feat_samples [B,S,N,F] / rel_samples [B,S,N,N,R]: per-sample inputs of
      the sg-branch under the reference's pairing skew, else None.
    """

    adj: torch.Tensor
    features: torch.Tensor
    coords: torch.Tensor
    rel: torch.Tensor
    adj_samples: Optional[torch.Tensor] = None
    factors: Optional[torch.Tensor] = None
    node_mask: Optional[torch.Tensor] = None
    feat_samples: Optional[torch.Tensor] = None
    rel_samples: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.adj.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[1]

    @property
    def num_samples(self) -> int:
        return 1 if self.adj_samples is None else self.adj_samples.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def _map(self, fn, names=None) -> "GraphBatch":
        names = names or [f.name for f in fields(self)]
        return replace(self, **{
            n: None if getattr(self, n) is None else fn(getattr(self, n))
            for n in names
        })

    def slice_batch(self, start: int, size: int) -> "GraphBatch":
        """Contiguous batch slice (the reference's batching, main.py:315-323)."""
        return self._map(lambda t: t[start:start + size])

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "GraphBatch":
        """Move every tensor to ``device``; with ``dtype``, also cast the
        float inputs (not ``factors``)."""
        out = self._map(lambda t: t.to(device)) if device is not None else self
        if dtype is not None:
            out = out._map(lambda t: t.to(dtype), _FLOAT_FIELDS)
        return out


def from_numpy(
    adj: np.ndarray,
    features: np.ndarray,
    coords: np.ndarray,
    rel: np.ndarray,
    adj_samples: Optional[np.ndarray] = None,
    factors: Optional[np.ndarray] = None,
    node_mask: Optional[np.ndarray] = None,
    feat_samples: Optional[np.ndarray] = None,
    rel_samples: Optional[np.ndarray] = None,
    dtype: torch.dtype = torch.float32,
) -> GraphBatch:
    """A GraphBatch from host arrays.  ``rel`` may be [B,N,N] (on-disk
    layout) or [B,N,N,R] and features [B,N] or [B,N,F]; the trailing axis
    is added when missing.  Every array, ``factors`` too, becomes
    ``dtype``."""
    if rel.ndim == 3:
        rel = rel[..., None]
    if features.ndim == 2:
        features = features[..., None]
    if rel_samples is not None and rel_samples.ndim == 4:
        rel_samples = rel_samples[..., None]
    if feat_samples is not None and feat_samples.ndim == 3:
        feat_samples = feat_samples[..., None]
    as_t = lambda x: None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype)
    return GraphBatch(
        adj=as_t(adj),
        features=as_t(features),
        coords=as_t(coords),
        rel=as_t(rel),
        adj_samples=as_t(adj_samples),
        factors=as_t(factors),
        node_mask=as_t(node_mask),
        feat_samples=as_t(feat_samples),
        rel_samples=as_t(rel_samples),
    )
