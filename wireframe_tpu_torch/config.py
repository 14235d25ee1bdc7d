"""Single config tree for data / model / train / eval.

The port's own copy of `wireframe_tpu/config.py`: the same dataclass
tree, yaml layout, `--set` override syntax and derived fields, so a yaml
or a checkpoint's `config_to_dict` means the same thing to both
packages (tests/test_torch_config.py holds them equal).  Knobs that
only the JAX package acts on (mesh layout, Pallas tiles for training)
are kept so every config round-trips unchanged.

The reference scatters its knobs across a yaml (dataset only,
`datasets/dataset_config.yaml:1-7`) and hard-coded constants
(batch size `main.py:44`, epochs/lr `main.py:50`, loss weights
`train.py:91-93`, thresholds `evaluate.py:60,81`).  Here everything lives
in one dataclass tree with yaml + CLI overrides; the defaults ARE the
reference's values so a default run reproduces the reference regime.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

# The shipped recipe: the default model of the bench and the measuring
# tools.
RECIPE_YAML = (Path(__file__).resolve().parents[1] / "configs"
               / "recommended.yaml")


@dataclass
class DataConfig:
    """Building3D dataset knobs (reference: datasets/dataset_config.yaml)."""

    root_dir: str = "./datasets"
    num_points: int = 2560
    use_color: bool = True
    use_intensity: bool = True
    normalize: bool = True
    # Scale the raw ~46-48k intensity column by 2^16.  The reference
    # leaves it unscaled (quirk 3), which drowns the unit-sphere geometry
    # channels at the first layer; set False for strict numeric parity.
    scale_intensity: bool = True
    augment: bool = True
    # TPU additions: fixed-shape padding targets.
    max_vertices: int = 64          # vertex slots (reference derives from batch)
    # Point-count buckets for inference on raw (unsampled) clouds; training
    # always uses num_points.  Bounds recompilation to len(buckets) programs.
    point_buckets: Tuple[int, ...] = (2048, 4096, 8192, 16384)
    seed: int = 0
    # Sort each cloud's rows by z on the host (stable, after
    # sampling/augment).  The decoder's KV window pool needs z-coherent
    # windows; sorting here instead of in-graph saves the per-step
    # (B, N) sort + (B, N, 8) row gather (~1.3 ms at the B=64 recipe).
    # Every device augmentation preserves z-order (z-rotation, x/y
    # flips, positive scale) except the tiny jitter noise, whose window
    # scrambling is spatially negligible.  Off by default: the reference
    # pipeline does not reorder points, and file-level parity tests
    # compare against it row-for-row.
    z_sort_points: bool = False

    @property
    def input_dim(self) -> int:
        if self.use_color and self.use_intensity:
            return 8
        if self.use_color:
            return 7
        if self.use_intensity:
            return 4
        return 3


@dataclass
class ModelConfig:
    """Architecture dims (reference: models/*.py __init__ defaults)."""

    input_dim: int = 8
    # Encoder (models/PointNetEncoder.py:19)
    encoder_hidden_dims: Tuple[int, ...] = (512, 1024, 2048, 1024)
    encoder_output_dim: int = 512
    # Vertex head (models/VertexPredictor.py:13)
    max_vertices: int = 64
    vertex_dim: int = 4
    # Edge head (models/EdgePredictor.py:19)
    edge_hidden_dim: int = 512
    edge_num_heads: int = 8
    attn_dropout: float = 0.1
    edge_dropout: float = 0.1
    # Vertex head selection: "mlp" = reference-parity global-feature MLP
    # (models/VertexPredictor.py); "query" = DETR-style slot queries
    # cross-attending to per-point features (anti-collapse head,
    # models/vertex_query_head.py — QUALITY.md §3).
    vertex_head: str = "mlp"
    decoder_dim: int = 256
    decoder_layers: int = 4
    decoder_heads: int = 8
    decoder_ffn_dim: int = 1024
    decoder_dropout: float = 0.0
    # Rematerialize each decoder block in the backward pass: the fwd
    # saves only block inputs, so the per-layer K/V projections and the
    # (B, H, V, N) cross-attention weights are recomputed instead of
    # stashed to HBM — a bandwidth-for-MXU trade for the train-step tail
    # (r2 VERDICT weak #2).  Numerically identical gradients.
    decoder_remat: bool = False
    # Masked window max-pool of the decoder's KV tokens along the point
    # axis (window size; 1 = off).  ROADMAP #17: at B=64 the ops on the
    # N=2560 KV axis (per-layer K/V projections + cross-attention bwd)
    # are ~9 ms of the 58 ms step; pooling N -> N/w shrinks that work
    # w-fold for every decoder layer.  Pooling happens in encoder-feature
    # space (PointNet features are max-pool-compatible by construction);
    # windows with no valid point are masked out of the attention.
    decoder_kv_pool: int = 1
    # Project all decoder layers' cross-attention K/V from the shared KV
    # tokens in one batched matmul pair ((D) -> (L, H, hd)) instead of
    # 2 matmuls per layer — a dispatch-tail lever (ROADMAP #19: ~4.3k
    # fused ops/step with nothing above 1.1 ms).  Same function class
    # and parameter count, DIFFERENT param layout: checkpoints do not
    # interchange across this flag (recorded in checkpoint metadata).
    decoder_fused_cross_kv: bool = False
    # Roll the decoder's layer stack into one lax.scan'ed block (stacked
    # (L, ...) params) instead of `decoder_layers` unrolled subgraphs —
    # the other dispatch-tail lever (r3 VERDICT weak #4).  Same per-layer
    # math; DIFFERENT param layout, so checkpoints do not interchange
    # across this flag (recorded in checkpoint metadata).  Measured at
    # the B=64 recipe before adopting (ROADMAP).
    decoder_scan: bool = False
    # Derived from data.z_sort_points (__post_init__): the loader already
    # z-sorted the rows, so the model skips its in-graph sort + gather.
    points_z_sorted: bool = False
    # Feed the decoder's per-slot features to the edge head alongside the
    # coordinates (query head only; the reference edge head sees coords
    # only, models/EdgePredictor.py:31-38).
    edge_use_slot_features: bool = False
    # Which slots count as "live" for the edge head + decode:
    # "prefix"    — slots < count (reference convention,
    #               PointCloudToWireframe.py:87-97);
    # "existence" — per-slot existence prob > threshold (needed with
    #               Hungarian-matched existence labels, where live slots
    #               are not a prefix).
    slot_mask_mode: str = "prefix"
    # TPU knobs
    compute_dtype: str = "float32"   # "bfloat16" for the fast path
    use_pallas_encoder: bool = False  # fused Pallas point-MLP+pool kernel
    pallas_tile: int = 512            # points per kernel grid step
    # Tile for the TRAINING chain kernel only (0 = use pallas_tile).
    # The two paths prefer different tiles on v5e at N=2560: the fused
    # inference kernel is 2.1x faster at 512 than 256, while the
    # custom-VJP train chain is ~5% faster at 256 than 512 (measured
    # B=64/B=128, tools/profile_train_step.py round 3).  The chain is
    # pointwise per tile (pooling stays in XLA); tile size affects
    # numerics only via matmul reduction blocking (~1e-6 float noise,
    # tested in test_pallas_chain_grad.py).
    pallas_chain_tile: int = 256
    # Training backward flavor for the fused encoder: "remat" (minimal
    # HBM, 3x-forward MXU) | "stash" (store pre-LN activations, 2x MXU).
    chain_backward: str = "remat"
    return_point_features: bool = False  # skip (B,N,512) HBM write when False
    # Point backbone: "pointnet" (the per-point MLP above) or "ptv3"
    # (Point Transformer V3, models/ptv3.py, whose 64-channel output the
    # encoder projects to encoder_output_dim).  The ptv3_ keys are
    # Pointcept's `PointTransformerV3` arguments (defaults: its ScanNet
    # base config, patch size 1024; the arguments that config leaves at
    # their defaults are constants of models/ptv3.py); `ptv3_capacity` is
    # each stage's packed row capacity as a share of the batch's B * N
    # input rows (1.0 can never overflow: a stage keeps at most the rows
    # of the stage before it).
    # Port-only keys: `config_to_dict` leaves them out of a pointnet
    # model's tree, which so stays the JAX package's.
    encoder: str = "pointnet"
    ptv3_enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    ptv3_enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    ptv3_enc_num_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    ptv3_dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    ptv3_dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    ptv3_dec_num_head: Tuple[int, ...] = (4, 4, 8, 16)
    ptv3_patch_size: int = 1024
    ptv3_drop_path: float = 0.3
    ptv3_grid_size: float = 0.02
    ptv3_capacity: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    # "ptv2": Point Transformer V2 (models/ptv2.py, `PT-v2m2`), whose
    # 48-channel output the encoder projects to encoder_output_dim.  The
    # ptv2_ keys are Pointcept's `PointTransformerV2` arguments (defaults:
    # its ScanNet base config; qkv bias, the positional bias without the
    # multiplier, the map unpooling and drop path 0.3 are constants of
    # models/ptv2.py); `ptv2_grid_size` is the grid sampling before the
    # backbone and `ptv2_capacity` each level's packed rows as a share of
    # B * N, as `ptv3_capacity` (1.0 can never overflow).
    ptv2_patch_embed_depth: int = 1
    ptv2_patch_embed_channels: int = 48
    ptv2_patch_embed_groups: int = 6
    ptv2_patch_embed_neighbours: int = 8
    ptv2_enc_depths: Tuple[int, ...] = (2, 2, 6, 2)
    ptv2_enc_channels: Tuple[int, ...] = (96, 192, 384, 512)
    ptv2_enc_groups: Tuple[int, ...] = (12, 24, 48, 64)
    ptv2_enc_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    ptv2_dec_depths: Tuple[int, ...] = (1, 1, 1, 1)
    ptv2_dec_channels: Tuple[int, ...] = (48, 96, 192, 384)
    ptv2_dec_groups: Tuple[int, ...] = (6, 12, 24, 48)
    ptv2_dec_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    ptv2_grid_sizes: Tuple[float, ...] = (0.06, 0.12, 0.24, 0.48)
    ptv2_grid_size: float = 0.02
    ptv2_capacity: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)


@dataclass
class TrainConfig:
    """Training regime (reference: main.py:44-50, train.py:90-96,141)."""

    batch_size: int = 3
    num_epochs: int = 1000
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    adam_eps: float = 1e-8
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip_norm: float = 1.0
    # Run the whole optimizer chain on one concatenated parameter vector
    # (optax.flatten): identical updates, ~100 fewer small per-leaf XLA
    # ops per step at the cost of a ravel/unravel copy each step.
    # Changes the opt_state pytree, so checkpoints don't interchange
    # across this flag.
    flatten_optimizer: bool = False
    # Loss weights (train.py:91-93)
    vertex_weight: float = 3.0
    edge_weight: float = 1.0
    existence_weight: float = 1.5
    # Reference behavior: overfit the first batch for num_epochs
    # (train.py:25).  overfit_one_batch=False gives a real epoch loop.
    overfit_one_batch: bool = True
    log_every: int = 20
    checkpoint_every: int = 200
    checkpoint_dir: str = "checkpoints"
    # "auto" (pallas kernel on TPU, XLA loop elsewhere) | "device"
    # (XLA-loop JV) | "pallas" (lockstep Pallas kernel) | "scipy"
    # (host-callback oracle).
    matcher: str = "auto"
    # Also keep the best-loss params and save them as step_<N>_best at the
    # end (the reference tracks best but saves final — quirk 6; this is
    # the documented "add best-checkpoint option").
    save_best: bool = False
    # Supervise edge pairs through the Hungarian matching instead of the
    # reference's positional slot<->GT-order comparison (quirk 4).  Off by
    # default = reference behavior.
    matched_edge_labels: bool = False
    # DETR-style existence supervision: label slot i "exists" iff the
    # Hungarian matching paired it with a real target, instead of the
    # reference's positional prefix labels (train.py:51-59).  Prefix
    # labels fight the matched vertex loss whenever the matching is not
    # the identity — a collapse driver (QUALITY.md §3).
    matched_existence_labels: bool = False
    # Exponential moving average of params (0 = off).  A variance lever
    # for the final-checkpoint quality (r2 VERDICT weak #1: single-seed
    # spread ±0.06 E-F1); when on, the EMA weights are saved as an extra
    # `<checkpoint_dir>/ema` checkpoint that evaluate.py consumes as-is.
    ema_decay: float = 0.0
    # LR schedule: "constant" (reference, train.py:96) or "warmup_cosine"
    # (linear warmup for warmup_steps, cosine decay to
    # learning_rate * lr_min_ratio over the run).
    lr_schedule: str = "constant"
    warmup_steps: int = 200
    lr_min_ratio: float = 0.01
    seed: int = 0
    # Warm-start: initialize params from the latest checkpoint under this
    # directory (fresh optimizer state and epoch counter — unlike
    # `--resume`, which restores both).  The synthetic-pretrain →
    # real-finetune lever (QUALITY.md round-4 study); architecture must
    # match the checkpoint's.
    init_from: str = ""
    # Mixed co-training: draw `cotrain_count` samples of every batch
    # i.i.d. from a second corpus at `cotrain_root` (same
    # <root>/{train,test}/{xyz,wireframe} layout — e.g. a
    # tools/gen_demo_data.py synthetic corpus), the rest from the
    # primary corpus.  The alternative topology lever to
    # pretrain->finetune (which moved geometry but not E-F1,
    # QUALITY.md round 4): synthetic wireframe topology enters every
    # gradient instead of being forgotten during finetuning.  An
    # "epoch" remains one pass over the primary corpus.
    cotrain_root: str = ""
    cotrain_count: int = 0
    # Device-side augmentation inside the jitted step (TPU-first replacement
    # for the host numpy augment at building3d.py:131-146).
    device_augment: bool = True
    # Extended augmentation levers beyond the reference's flips + ±5°
    # z-rotation (defaults reproduce the reference exactly).  The train
    # corpus is 43 buildings, so regularization-by-augmentation is the
    # main generalization lever (QUALITY.md: seed variance dominates).
    aug_rot_degrees: float = 5.0      # z-rotation range (± degrees)
    aug_jitter_std: float = 0.0       # Gaussian XYZ noise on POINTS only
    aug_scale_range: float = 0.0      # uniform scale in [1-r, 1+r], cloud+verts


@dataclass
class EvalConfig:
    """Evaluation knobs (reference: evaluate.py:60,81)."""

    distance_thresh: float = 1.0
    edge_confidence_thresh: float = 0.5
    vertex_existence_thresh: float = 0.5
    batch_size: int = 3
    # Reference parity counts ALL max_vertices slots as predicted corners
    # (evaluate.py:76 never filters by existence), so corner precision is
    # denominated by the slot count.  live_corner_filter=true counts only
    # live slots (existence slot-mask mode) — the corner set test.py and
    # serve.py actually emit.  Off by default for parity with the
    # reference's published numbers.
    live_corner_filter: bool = False


@dataclass
class ParallelConfig:
    """Mesh/sharding layout.  The reference has no distributed code; this is
    the additive TPU scaling path (SURVEY.md §2 parallelism table)."""

    dp: int = -1          # data-parallel ways; -1 = all devices
    mp: int = 1           # point/model axis ways (sharded pooling)
    mesh_axis_names: Tuple[str, str] = ("dp", "mp")


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        # Keep the two places max_vertices / input_dim live in sync.
        self.model.max_vertices = self.data.max_vertices
        self.model.input_dim = self.data.input_dim
        self.model.points_z_sorted = self.data.z_sort_points


def _apply_overrides(obj: Any, flat: dict) -> None:
    for key, value in flat.items():
        parts = key.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        leaf = parts[-1]
        if not hasattr(target, leaf):
            raise KeyError(f"Unknown config key: {key}")
        current = getattr(target, leaf)
        if isinstance(current, bool):
            value = str(value).lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        elif isinstance(current, tuple):
            elem = type(current[0]) if current else int
            if isinstance(value, str):
                value = tuple(elem(v) for v in value.split(","))
            else:
                value = tuple(value)
        setattr(target, leaf, value)
        # model.max_vertices / model.input_dim are derived from the data
        # section in __post_init__; forward explicit model-side overrides
        # to their source of truth instead of silently clobbering them.
        if key == "model.max_vertices":
            obj.data.max_vertices = int(value)
        if key == "model.input_dim":
            raise KeyError(
                "model.input_dim is derived from data.use_color/"
                "use_intensity; override those instead")
        if key == "model.points_z_sorted":
            raise KeyError(
                "model.points_z_sorted is derived from "
                "data.z_sort_points; override that instead")


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Sequence[str]] = None) -> Config:
    """Build a Config from an optional yaml file plus `k.e.y=value` overrides.

    Accepts both this framework's nested layout and the reference's
    `Building3D:` dataset yaml (datasets/dataset_config.yaml) for drop-in
    compatibility.
    """
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
        if "Building3D" in raw:  # reference-format dataset yaml
            for k, v in raw["Building3D"].items():
                if hasattr(cfg.data, k):
                    setattr(cfg.data, k, v)
        for section in ("data", "model", "train", "eval", "parallel"):
            if section in raw:
                for k, v in raw[section].items():
                    sec = getattr(cfg, section)
                    if hasattr(sec, k):
                        setattr(sec, k, tuple(v) if isinstance(
                            getattr(sec, k), tuple) else v)
    if overrides:
        flat = {}
        for ov in overrides:
            k, _, v = ov.partition("=")
            flat[k.strip()] = v.strip()
        _apply_overrides(cfg, flat)
    cfg.__post_init__()
    return cfg


PORT_ONLY_MODEL_KEYS = tuple(
    f.name for f in dataclasses.fields(ModelConfig)
    if f.name == "encoder" or f.name.startswith(("ptv3_", "ptv2_")))


def unused_model_keys(encoder: str) -> Tuple[str, ...]:
    """The port-only keys a model with this point backbone does not read:
    all of them for "pointnet" (whose tree so stays the JAX package's),
    the other backbone's `ptv*_` keys otherwise."""
    if encoder == "pointnet":
        return PORT_ONLY_MODEL_KEYS
    return tuple(k for k in PORT_ONLY_MODEL_KEYS
                 if k != "encoder" and not k.startswith(encoder + "_"))


def config_to_dict(cfg: Config) -> dict:
    out = dataclasses.asdict(cfg)
    for key in unused_model_keys(cfg.model.encoder):
        del out["model"][key]
    return out


def apply_saved_model_config(cfg: Config, saved: dict) -> Config:
    """Overwrite cfg's MODEL architecture fields from a saved
    `config_to_dict` tree (a checkpoint's config.json).

    Mirrors `wireframe_tpu.train.checkpoint.apply_checkpoint_model_config`:
    the architecture comes from the checkpoint, data/eval knobs stay
    caller-controlled except the input-feature semantics the weights were
    trained under.
    """
    model = saved.get("model")
    if model:
        # A tree without the port-only keys is a pointnet model's.
        for f in dataclasses.fields(ModelConfig):
            if f.name in PORT_ONLY_MODEL_KEYS and f.name not in model:
                setattr(cfg.model, f.name, f.default)
        for key, value in model.items():
            if hasattr(cfg.model, key):
                current = getattr(cfg.model, key)
                setattr(cfg.model, key,
                        tuple(value) if isinstance(current, tuple) else value)
        cfg.data.max_vertices = cfg.model.max_vertices
    for key in ("use_color", "use_intensity", "scale_intensity",
                "normalize"):
        if key in saved.get("data", {}):
            setattr(cfg.data, key, saved["data"][key])
    cfg.__post_init__()
    return cfg


def config_to_json(cfg: Config) -> str:
    return json.dumps(config_to_dict(cfg), indent=2)
