"""Typed configuration (copy of ``ganleaks_tpu.config``'s attack,
evaluation, FID, LPIPS scoring, victim training — DCGAN, WGAN-GP, PGGAN,
VAE-GAN, medGAN and the privGAN extras — and data split parts): one
dataclass per entry point, a YAML loader (PyYAML imported only when a
file or a raw string needs parsing), ``key=value`` overrides whose unknown
keys raise, and the privGAN grid sweep's :func:`expand_grid` /
:func:`sweep_tag`.

The fields are the JAX package's, so existing YAML configs load unchanged.
A trainer's ``mesh_shape`` other than ``(1,)`` (data-parallel training,
not ported yet) is accepted here and refused by the trainer with a
pointer to the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import types
import typing
from dataclasses import dataclass
from typing import Any, Iterator, Sequence, Type, TypeVar, Union

T = TypeVar("T")


_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_BOOL = {w: b for b, words in ((True, "yes true on"),
                                    (False, "no false off"))
              for word in words.split()
              for w in (word, word.capitalize(), word.upper())}


def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML values and raw ``key=value`` strings
    onto dataclass field types. A string is parsed by the field's type
    alone (YAML 1.1's null and bool words where the type admits them), so
    an override parses the same with or without PyYAML installed."""
    if value is None:
        return None
    origin = getattr(typ, "__origin__", None)
    if origin in (list, tuple, Sequence):
        inner = typ.__args__[0] if getattr(typ, "__args__", None) else None
        if isinstance(value, str):
            # raw CLI strings: parse "[4, 2]" as a list (iterating the
            # string would yield its characters)
            try:
                import yaml
                value = yaml.safe_load(value)
            except ImportError:
                value = json.loads(value)
        if not isinstance(value, (list, tuple)):
            value = [value]
        seq = [(_coerce(v, inner) if inner else v) for v in value]
        return tuple(seq) if origin is tuple else seq
    members = (typing.get_args(typ)
               if typing.get_origin(typ) in (Union, types.UnionType) else None)
    if members is not None and isinstance(value, str):
        if type(None) in members and value.strip() in _YAML_NULL:
            return None
        if bool in members and value.strip() in _YAML_BOOL:
            return _YAML_BOOL[value.strip()]
        for member in members:
            if member in (int, float, str):
                try:
                    return member(value)
                except ValueError:
                    continue
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def _resolve_type(cls: type, name: str) -> Any:
    return typing.get_type_hints(cls).get(name, Any)


def apply_overrides(cfg: T, overrides: dict[str, Any]) -> T:
    """Return a copy of ``cfg`` with ``overrides`` applied; unknown keys
    raise so typos fail loudly."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    clean: dict[str, Any] = {}
    for key, val in overrides.items():
        if key not in fields:
            raise KeyError(
                f"unknown config key {key!r} for {type(cfg).__name__}; "
                f"valid keys: {sorted(fields)}")
        clean[key] = _coerce(val, _resolve_type(type(cfg), key))
    return dataclasses.replace(cfg, **clean)


def load_config(cls: Type[T], yaml_path: str | None = None,
                overrides: dict[str, Any] | None = None) -> T:
    """Build a config: dataclass defaults <- YAML file <- explicit
    overrides."""
    cfg = cls()
    if yaml_path is not None:
        import yaml
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = apply_overrides(cfg, data)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def expand_grid(grid: dict[str, Any]) -> Iterator[dict[str, Any]]:
    """Expand a {key: list-of-values} YAML into per-experiment override
    dicts, the ``itertools.product`` sweep of ``privDCGAN.py:73-92`` /
    ``privPGGAN.py:248-266``; scalar values are single-element axes."""
    keys = list(grid)
    axes = [v if isinstance(v, (list, tuple)) else [v] for v in grid.values()]
    for combo in itertools.product(*axes):
        yield dict(zip(keys, combo))


def sweep_tag(overrides: dict[str, Any]) -> tuple[str, str]:
    """(keys, values) path components of a sweep run, the reference's
    ``'-'.join(keys)`` / ``'-'.join(values)`` layout
    (``privDCGAN.py:80,92``)."""
    return "-".join(overrides), "-".join(str(v) for v in overrides.values())


@dataclass
class AttackConfig:
    """fbb attack configuration (reference ``attack_models/fbb.py:18-38``);
    field for field the JAX package's ``AttackConfig``, plus
    ``auto_plan``."""

    exp_name: str = "debug"
    syn_data_path: str | None = None
    pos_data_dir: str = "data/miniCelebA/train"
    neg_data_dir: str = "data/miniCelebA/test"
    data_num: int = 20000          # number of query images considered
    input_format: str = "auto"     # 'png' | 'npz' | 'auto' per image-set path
    resolution: int = 64
    K: int = 1                     # reference config K=1 (always 1-NN)
    BATCH_SIZE: int = 64           # reference kNN batch (drop_remainder only)
    distance: str = "l2-lpips"     # 'l2' | 'l2-lpips'
    lpips_net: str = "vgg"         # 'vgg' | 'alex' | 'squeeze' | 'resnet'
    lpips_weights: str | None = None  # LPIPS npz (JAX save_lpips_params schema)
    hyperparameter_search: bool = False
    params: str | None = None
    save_root: str = "fbb_attack"
    engine: str = "gemm"           # 'auto' | 'gemm' (torch.matmul fold) |
                                   # 'pallas' (the fused CUDA
                                   # distance+argmin kernel; the name is
                                   # kept so existing configs run) |
                                   # 'exact' (elementwise reference math) |
                                   # 'taps' / 'taps-int8' (tap-structured
                                   # parts, the tap epilogue kernel; int8
                                   # products for taps-int8)
    dtype: str = "float32"         # embedding dtype: 'float32' | 'bfloat16'
    lpips_compute_dtype: str | None = None  # tower dtype ('bfloat16')
    two_pass: bool = False         # certified two-pass exact-index mode
    two_pass_k: int = 4            # pass-1 candidates per query
    query_block: int = 2048        # queries featurised per block
    syn_block: int = 8192          # synthetic rows featurised per block
    query_cache_gb: float = 8.0    # requested device GiB for the
                                   # query-embedding cache, which sets the
                                   # number of synthetic sweeps; on a card
                                   # the planner (ops/stream_plan) raises
                                   # it to one sweep where that fits and
                                   # caps it where it cannot fit
    auto_plan: bool = True         # the device-memory planner; False keeps
                                   # query_cache_gb and the blocks exactly
                                   # as given (fixed-config experiments;
                                   # the JAX package's GANLEAKS_NO_AUTO_PLAN)
    uint8_storage: bool = True     # keep image sets as uint8 bytes
    host_stream: bool | str = "auto"  # where the image sets live during
                                   # the search: True in host memory (one
                                   # block shipped at a time; a PNG
                                   # synthetic dir decoded as it is read,
                                   # io/stream.HostImageSet), False on
                                   # the card (copied once), 'auto' on the
                                   # card where they fit beside the
                                   # search's planned memory, else host
    decode_cache: bool | str = "auto"  # decoded-PNG disk cache
                                   # (io/diskcache): 'auto' beside the data,
                                   # False/'off' none, a path pins the dir
    drop_remainder: bool = False   # replicate fbb.py:77 remainder drop
    n_chips: int = 1               # devices of the mesh, one rank each
    shard_layout: str = "sharded"  # 'sharded' | 'ring' (parallel/knn_shard)
    multihost: bool = False        # join the process group first
    save_plots: bool = True        # the 20 closest-pair PNGs
    wandb: str | None = None
    seed: int = 0


@dataclass
class ReconstructionConfig:
    """Encoder-seeded reconstruction attack (BASELINE config #3: VAE-GAN);
    field for field the JAX package's ``ReconstructionConfig``. The artifact
    layout mirrors the fbb attack's so ``eval_roc`` consumes the run
    unchanged."""

    exp_name: str = "recon_debug"
    pos_data_dir: str = "data/miniCelebA/train"
    neg_data_dir: str = "data/miniCelebA/test"
    data_num: int = 20000
    resolution: int = 64
    reader: str = "center_crop"    # VAE-GAN trains on the center-crop reader
                                   # (vaegan/utils.py:44-71); 'resize' = fbb's
    # encoder weights: .msgpack or .npz (the trainers, tools/convert_victim)
    netE: str = ""
    netG: str = ""                 # generator weights
    z_dim: int = 100               # must match the checkpoint (train.py:30)
    d: int = 64
    distance: str = "l2"           # 'l2' | 'l2-lpips' (same metric family as fbb)
    lpips_net: str = "vgg"         # 'vgg' | 'alex' | 'squeeze' | 'resnet'
    lpips_weights: str | None = None
    batch: int = 256
    save_root: str = "recon_attack"
    save_plots: bool = True
    wandb: str | None = None
    seed: int = 0


@dataclass
class TabularAttackConfig:
    """fbb attack on (N, D) tabular records (medGAN's ``synthetic.npy``,
    reference ``gan_models/medgan/train.py:247-318``); field for field the
    JAX package's ``TabularAttackConfig``."""

    exp_name: str = "fbb_tabular_debug"
    syn_data_path: str | None = None     # synthetic.npy / .npz / .csv
    pos_data_path: str | None = None     # member rows (.npy/.npz/.csv)
    neg_data_path: str | None = None     # non-member rows
    dataset_csv: str | None = None       # alternative: the medGAN CSV; the
                                         # reference 90/10 split defines
                                         # members/non-members
    data_num: int = 20000
    engine: str = "gemm"                 # 'gemm' | 'pallas' (the fused CUDA
                                         # distance+argmin kernel) | 'exact'
    syn_block: int = 8192
    save_root: str = "fbb_attack"
    wandb: str | None = None
    seed: int = 0


@dataclass
class FIDConfig:
    batch_size: int = 50           # z_fid.py:68
    weights: str | None = None     # InceptionV3 weights npz (JAX schema)
    sqrtm: str = "newton-schulz"   # 'newton-schulz' | 'eigh' | 'scipy'


@dataclass
class ScoresConfig:
    """Perceptual-metric evaluation against human judgments — the
    DistModel scoring surface (``dist_model.py:253-330``) the reference
    exposes only as library calls. Dataset is the original LPIPS layout:
    ``data_dir/{ref,p0,p1}/*.png + judge/*.npy`` for 2AFC,
    ``data_dir/{p0,p1}/*.png + same/*.npy`` for JND; or a single .npz
    with those arrays (keys ref/p0/p1/judge or p0/p1/same)."""

    data_dir: str = ""             # directory layout or a .npz path
    mode: str = "2afc"             # '2afc' | 'jnd'
    model: str = "net-lin"         # 'net-lin' | 'net' | 'l2' | 'ssim'
    net: str = "vgg"               # backbone for net-lin/net
    colorspace: str = "Lab"        # for l2/ssim (dist_model.py:39)
    weights: str | None = None     # lpips params npz (surrogate otherwise)
    resolution: int = 64
    batch_size: int = 256
    limit: int | None = None       # cap on triplets/pairs (smoke runs)
    out_json: str | None = None


@dataclass
class EvalConfig:
    """ROC evaluation (reference ``attack_models/eval_roc.py:43-55``)."""

    result_load_dir: str | None = None
    attack_type: str = "fbb"                 # 'fbb' | 'pbb' | 'wb'
    reference_load_dir: str | None = None    # optional calibration scores
    save_dir: bool = True
    precision_threshold: float = -0.14       # hardcoded in eval_roc.py:21-23
    wandb: str | None = None
    # non-finite losses are refused unless the caller opts in; the result
    # then carries degenerate=True
    allow_nonfinite: bool = False


# ---------------------------------------------------------------------------
# victim model configs (reference: gan_models/*)
# ---------------------------------------------------------------------------

@dataclass
class TrainCommon:
    """Fields shared by every victim trainer (the repeated argparse block,
    e.g. ``gan_models/dcgan/train_torch.py:23-50``)."""

    data_path: str = "data/train"
    image_size: int = 64
    nc: int = 3
    batch_size: int = 128
    num_epochs: int = 5
    seed: int = 0
    save_model: bool = True
    saved_model_name: str | None = None  # a run dir holding generator.pth
    training: bool = True
    generate: bool = True
    PATH: str = "model_save"
    PATH_syn_data: str = "syn_data"
    wandb: str | None = None
    # per-epoch generated-sample grids (reference: wandb image logging,
    # train_torch.py:125-127); "auto" -> <PATH>/sample_grids, None disables
    sample_grid_dir: str | None = "auto"
    # data-parallel mesh over the batch axis: only (1,) is ported (ROADMAP
    # M12); anything else raises
    mesh_shape: tuple[int, ...] = (1,)


@dataclass
class DCGANConfig(TrainCommon):
    """``gan_models/dcgan/train_torch.py:23-50`` + ``dcgan_config.yaml``."""

    lr: float = 2e-4
    nz: int = 100
    ngf: int = 64
    ndf: int = 64
    beta1: float = 0.5
    beta2: float = 0.999
    num_generated: int = 2040


@dataclass
class WGANGPConfig(TrainCommon):
    """``gan_models/wgangp/train.py:24-53``."""

    lr: float = 4e-4
    nz: int = 100
    ngf: int = 64
    ndf: int = 64
    beta1: float = 0.0
    beta2: float = 0.9
    critic_iter: int = 5
    lambda_gp: float = 10.0
    num_generated: int = 2040


@dataclass
class PGGANConfig(TrainCommon):
    """``gan_models/pggan/train.py:24-48`` + ``pggan_config.yaml``."""

    lr: float = 1e-3
    nz: int = 512
    in_channels: int = 512
    start_img_size: int = 4
    batch_sizes: tuple[int, ...] = (32, 32, 32, 32, 32)  # per resolution
    num_epochs: int = 30   # per resolution (PROGRESSIVE_EPOCHS, train.py:78)
    lambda_gp: float = 10.0
    drift: float = 0.001          # 0.001 * E[critic(real)^2] (train.py:116)
    num_generated: int = 10000
    # the reference's fp16 autocast (train.py:107) is a bfloat16 step here:
    # parameters and activations cast, losses and Adam in float32
    compute_dtype: str = "bfloat16"
    hflip: bool = True             # RandomHorizontalFlip(p=0.5), train.py:83


@dataclass
class VAEGANConfig(TrainCommon):
    """``gan_models/vaegan/train.py:27-38``."""

    exp_name: str = "vaegan_default"
    batch_size: int = 64
    z_dim: int = 100
    d: int = 64
    nepoch: int = 1000
    steps_per_epoch: int = 78     # 5000 // batch_size (train.py:297)
    num_samples: int = 20000      # sample.py:17
    checkpoint_every: int = 10    # train.py:401


@dataclass
class MedGANConfig(TrainCommon):
    """``gan_models/medgan/train.py:23-61``."""

    DATASETPATH: str = "data/mini_MIMIC_III/mini_MIMIC_III.csv"
    n_epochs: int = 1000
    n_epochs_pretrain: int = 100
    batch_size: int = 2000
    lr: float = 1e-3
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    latent_dim: int = 128
    hidden_gen: int = 128
    hidden_disc1: int = 128
    hidden_disc2: int = 256
    binary: bool = True
    minibatch_averaging: bool = True
    generate_N: int = 100


@dataclass
class PrivGANConfig:
    """privGAN extras shared by privDCGAN / privPGGAN
    (``privDCGAN.py:52-53``, the ``privPGGAN.py`` grid)."""

    N_splits: int = 2
    privacy_ratio: float = 0.5
    dp_delay: int = 100   # epoch gate for DCGAN; resolution gate for PGGAN
    disc_epochs: int = 2  # private-discriminator pretrain epochs


@dataclass
class SplitConfig:
    """CelebA member / non-member split (reference ``z_split.py:10-28``;
    ``tools/z_split``)."""

    num_images: int = 10020
    identity_annotations: str = "data/identities_ann.txt"
    input_dir: str = "data/img_align_celeba"
    output_dir0: str = "data/train"
    output_dir1: str = "data/celebAhuge_positive"
    output_dir2: str = "data/celebAhuge_negative"
    img_size: int = 64
    num_same_id: int = 30
    seed: int = 0
