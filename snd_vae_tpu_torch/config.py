"""Immutable configuration, kept field for field equal to the JAX package's
``snd_vae_tpu/config.py`` so that one set of values drives both packages.
One default differs: ``dataset_path`` names ``dataset/`` inside this
checkout, not ``../dataset/`` beside the working directory, so a run reads
no data from outside its checkout unless told to.

The port keeps its own copy: it imports nothing of ``snd_vae_tpu``.  The
reference's mutable TF flags (its ``main.py:39-103``) and per-dataset flag
blocks (``main.py:136-241``) become frozen dataclasses; the reference's
runtime shape bookkeeping becomes explicit ``[B, S, N, ...]`` axes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

MODEL_TYPES = (
    "base",            # joint single-latent model (reference model_joint.py)
    "disentangled",    # 3-branch beta-VAE          (reference model.py)
    "disentangled_C",  # capacity-annealed KL       (optimizer.py:166-174)
    "NED-VAE-IP",      # DIP-VAE covariance penalty (optimizer.py:176-182)
    "beta-TCVAE",      # total-correlation penalty  (optimizer.py:184-190)
    "geoGCN",          # geometric-GCN encoder baseline (layers.py:606-619)
    "posGCN",          # positional/structural GCN baseline (layers.py:759-784)
)

# where the reference's on-disk ``.npy`` layout is looked for; absent, the
# synthetic datasets are generated from the seed
DEFAULT_DATASET_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dataset"
)

DATASETS = ("synthetic1", "synthetic2", "synthetic3", "protein", "mnist", "scene")

RUN_TYPES = (
    "train",
    "test_reconstruct",
    "test_generation",
    "test_disentangle",
    "sample",
)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder architecture (reference flags ``spatial_conv_layers``,
    ``graph_conv_layers``, ``spatial_graph_conv_layers`` and their widths)."""

    # spatial (coordinate) branch: 1D convs over the node axis
    s_channels: Tuple[int, ...] = (10, 10, 20)
    s_kernel_sizes: Tuple[int, ...] = (5, 5, 5)
    s_strides: Tuple[int, ...] = (1, 1, 1)
    s_hidden_size: int = 100
    s_latent_size: int = 100

    # topology (graph) branch: stacked graph convolutions
    g_conv_hidden: Tuple[int, ...] = (10, 20)
    g_hidden_size: int = 100
    g_latent_size: int = 100

    # joint spatial-graph branch: spatial-motif graph convolutions
    sg_conv_hidden: Tuple[Tuple[int, ...], ...] = ((20, 20, 20), (50, 50, 50))
    sg_hidden_size: int = 100
    sg_latent_size: int = 100


@dataclass(frozen=True)
class DecoderConfig:
    """Decoder architecture (reference flags ``spatial_deconv_layers``,
    ``graph_deconv_layers``, ``e_d_hidden`` and ``node_h_size``)."""

    node_h_size: int = 20
    # coordinate head (1D convs)
    s_d_channels: Tuple[int, ...] = (50, 20, 10)
    s_d_kernel_sizes: Tuple[int, ...] = (5, 5, 5)
    s_d_strides: Tuple[int, ...] = (1, 1, 1)
    # node-feature head (1D convs)
    n_d_channels: Tuple[int, ...] = (50, 20)
    n_d_kernel_sizes: Tuple[int, ...] = (5, 5)
    n_d_strides: Tuple[int, ...] = (1, 1)
    # adjacency head (edge-to-edge convs)
    e_d_hidden: Tuple[int, ...] = (50, 20)
    # scene dataset: categorical edges with this many classes
    num_edge_feature: int = 2
    # corrected mode: feed the decoded coordinates' pairwise distances to the
    # adjacency head as an extra edge channel (off = reference behaviour)
    edge_from_coords: bool = False
    # with edge_from_coords: stop the adjacency loss's gradient at the
    # distance channel
    efc_stop_grad: bool = False
    # coordinate-head output activation: "auto" (the reference's choice per
    # model and dataset), "linear" or "sigmoid"
    coord_activation: str = "auto"
    # separable lowering of the adjacency head's first edge-to-edge layer;
    # None = auto (engaged at num_nodes >= adj_factored_min_nodes)
    adj_head_factored: Optional[bool] = None
    adj_factored_min_nodes: int = 96


@dataclass(frozen=True)
class LossConfig:
    """ELBO / regularizer configuration (reference optimizer.py:123-203)."""

    beta: float = 1.0
    # capacity-annealed KL (disentangled_C)
    c_max: float = 100.0
    c_stop_iter: float = 100.0
    c_step: float = 20.0
    gamma: float = 100.0
    # DIP-VAE (NED-VAE-IP)
    dip_lambda_od: float = 10.0
    dip_lambda_d: float = 100.0
    # beta-TCVAE weight
    tc_weight: float = 10.0
    # optional weighted-BCE edge loss (off = the reference's 2-class CE)
    use_weighted_bce: bool = False
    # corrected mode: train scene's shape head with categorical CE
    scene_node_loss: bool = False


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.001
    epochs: int = 2000
    batch_size: int = 10          # graphs per step (flag batch_size)
    dropout_keep_prob: float = 1.0  # the reference 'dropout' flag is a keep-prob
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    seed: int = 1
    restore_epoch: Optional[int] = None  # None = latest
    # corrected mode: re-permute the graph->batch assignment each epoch
    reshuffle: bool = False
    # corrected mode: re-draw the spanning-tree samples every k epochs (0 = off)
    resample_trees_every: int = 0
    # cap on seconds of device work per dispatch of the chunked trainer
    max_dispatch_s: float = 45.0
    # held-out evaluation cadence in epochs (0 = off)
    eval_every: int = 0
    # watched held-out metric for best-checkpoint tracking ("-" minimizes)
    best_metric: str = "edge_auc"
    # unroll factor of the per-batch loop inside one epoch program
    scan_unroll: int = 1
    # Adam formulation: "adam" or "tf1-adam" (TF1's epsilon placement)
    optimizer: str = "adam"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``data`` shards the graph batch, ``model`` the
    wide dense dimensions and the node axis of the large-N ops."""

    data: int = 1
    model: int = 1


@dataclass(frozen=True)
class Config:
    model_type: str = "disentangled"
    dataset: str = "synthetic2"
    dataset_path: str = DEFAULT_DATASET_PATH

    num_nodes: int = 25
    num_features: int = 1
    spatial_dim: int = 2
    rel_dim: int = 1
    sampling_num: int = 10        # spanning trees per graph (flag sampling_num)

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # latent-traversal controls
    visualize_length: int = 5
    traverse_dims: Tuple[int, int, int] = (77, 48, 171)

    # parity=True reproduces the reference's quirks (frozen batch norm,
    # mean-KL, logσ convention); False enables the corrected defaults
    parity: bool = True
    # reproduce the reference's spanning-tree / feature pairing skew
    reproduce_pairing_skew: bool = False
    # compute dtype of the hot path: "float32" or "bfloat16"
    compute_dtype: str = "float32"
    # corrected mode: map coordinates into the unit box by the train split's
    # scalar bounds
    normalize_coords: bool = False
    # rematerialize the motif convs and the adjacency head in backward
    remat: bool = False
    # selective remat policy ("recompute-big" | "dots-no-batch"; needs remat)
    remat_policy: Optional[str] = None
    # blocked streamed lowering of the motif convs (rows per block; must
    # divide num_nodes); None = monolithic
    motif_block_rows: Optional[int] = None

    @property
    def adj_factored_engaged(self) -> bool:
        """Whether the adjacency head's first E2E layer uses the separable
        lowering (DecoderConfig.adj_head_factored; auto by node count)."""
        if self.decoder.adj_head_factored is not None:
            return self.decoder.adj_head_factored
        return self.num_nodes >= self.decoder.adj_factored_min_nodes

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"model_type {self.model_type!r} not in {MODEL_TYPES}")
        if self.dataset not in DATASETS:
            raise ValueError(f"dataset {self.dataset!r} not in {DATASETS}")

    @property
    def is_disentangled(self) -> bool:
        return self.model_type != "base"

    @property
    def uses_3d_conv(self) -> bool:
        """Protein/mnist use the fourth-order conv (reference model.py:139-140)."""
        return self.dataset in ("protein", "mnist")

    def with_(self, **kw) -> "Config":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Per-dataset presets (the reference's main.py:136-241)
# ---------------------------------------------------------------------------

def synthetic1_preset(**overrides) -> Config:
    cfg = Config(
        dataset="synthetic1",
        num_nodes=25,
        spatial_dim=2,
        encoder=EncoderConfig(sg_hidden_size=500, sg_latent_size=500),
        decoder=DecoderConfig(node_h_size=50),
        train=TrainConfig(learning_rate=0.001, epochs=1000, batch_size=10),
    )
    return cfg.with_(**overrides)


def synthetic2_preset(**overrides) -> Config:
    cfg = Config(
        dataset="synthetic2",
        num_nodes=25,
        spatial_dim=2,
        encoder=EncoderConfig(sg_hidden_size=100, sg_latent_size=100),
        decoder=DecoderConfig(node_h_size=20),
        train=TrainConfig(learning_rate=0.0008, epochs=1000, batch_size=10),
    )
    return cfg.with_(**overrides)


def synthetic3_preset(**overrides) -> Config:
    """The reference defines no flag block for synthetic3; it takes the
    synthetic2 values with the same 2D geometry."""
    cfg = Config(
        dataset="synthetic3",
        num_nodes=25,
        spatial_dim=2,
        encoder=EncoderConfig(sg_hidden_size=100, sg_latent_size=100),
        decoder=DecoderConfig(node_h_size=20),
        train=TrainConfig(learning_rate=0.0008, epochs=1000, batch_size=10),
    )
    return cfg.with_(**overrides)


def protein_preset(**overrides) -> Config:
    cfg = Config(
        dataset="protein",
        num_nodes=50,
        spatial_dim=3,
        encoder=EncoderConfig(
            sg_conv_hidden=((10, 10, 10, 10), (20, 20, 20, 20)),
            sg_hidden_size=50,
            sg_latent_size=50,
            s_hidden_size=5,
            s_latent_size=5,
            g_hidden_size=5,
            g_latent_size=5,
        ),
        decoder=DecoderConfig(node_h_size=5),
        train=TrainConfig(batch_size=50),
    )
    return cfg.with_(**overrides)


def mnist_preset(**overrides) -> Config:
    cfg = Config(
        dataset="mnist",
        num_nodes=50,
        spatial_dim=3,
        encoder=EncoderConfig(
            sg_conv_hidden=((20, 20, 20, 20), (50, 50, 50, 50)),
        ),
        train=TrainConfig(batch_size=2),
    )
    return cfg.with_(**overrides)


def scene_preset(**overrides) -> Config:
    cfg = Config(
        dataset="scene",
        model_type="base",
        num_nodes=10,
        num_features=3,
        spatial_dim=3,
        decoder=DecoderConfig(num_edge_feature=5),
        train=TrainConfig(batch_size=2),
    )
    return cfg.with_(**overrides)


PRESETS = {
    "synthetic1": synthetic1_preset,
    "synthetic2": synthetic2_preset,
    "synthetic3": synthetic3_preset,
    "protein": protein_preset,
    "mnist": mnist_preset,
    "scene": scene_preset,
}


def preset(dataset: str, **overrides) -> Config:
    try:
        return PRESETS[dataset](**overrides)
    except KeyError:
        raise ValueError(f"no preset for dataset {dataset!r}; known: {list(PRESETS)}")


def apply_quality_overrides(cfg: Config) -> Config:
    """The per-dataset quality operating point of ``--quality`` (the JAX
    ``config.apply_quality_overrides``): scene only switches to bf16; every
    other dataset takes the weighted-BCE edge loss, the decoded-distance
    edge channel (``edge_from_coords``) and bf16, with beta 3 on synthetic1
    and 0.1 elsewhere; protein and mnist also normalize their coordinates
    into the unit box."""
    if cfg.dataset == "scene":
        return cfg.with_(compute_dtype="bfloat16")
    beta = 3.0 if cfg.dataset == "synthetic1" else 0.1
    cfg = cfg.with_(
        loss=replace(cfg.loss, beta=beta, use_weighted_bce=True),
        decoder=replace(cfg.decoder, edge_from_coords=True),
        compute_dtype="bfloat16",
    )
    if cfg.dataset in ("protein", "mnist"):
        cfg = cfg.with_(normalize_coords=True)
    return cfg
