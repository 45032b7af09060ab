"""Configuration system.

Mirrors the reference's two-tier config (YAML file -> Python config object ->
training core) with the same YAML schema and key names, so the reference's
benchmark configs run unchanged:

* reference Python side: ``cf/cf_config.py:5-40``, ``cf/utils.py:5-8``
* reference C++ POD:     ``src/modules/cf_config.hpp:12-35``
* reference YAML schema: ``cf/benchmarks/*/MF_CCL/configs/config0.yaml``

Unlike the reference (where YAML keys not consumed by CFConfig are read
ad-hoc by the driver or silently dropped), every key is parsed here and
unknown keys raise, so config drift is caught early.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import yaml

# Negative-sampler selector values (reference: cf_config.hpp:27 `neg_sampler`,
# dispatched at engine.cpp:195-201).
NEG_SAMPLER_UNIFORM = 0
NEG_SAMPLER_TILE = 1

# SGD semantics selector. "batch" is clean minibatch SGD (the TPU-idiomatic
# default). "accum" replicates the reference's quirk of persistent gradient
# rows that accumulate across a sub-epoch and are only zeroed at sub-epoch
# boundaries (engine.cpp:344-347; accumulation at matrix_factorization.cpp:
# 118-150 via `+=` into grad rows read from the grad table).
SGD_MODE_BATCH = "batch"
SGD_MODE_ACCUM = "accum"


@dataclasses.dataclass
class CFConfig:
    """Hyperparameters for a collaborative-filtering training run.

    Field names follow the reference CFConfig (cf_config.hpp:12-35) plus the
    model_config YAML keys the reference driver reads ad-hoc (epochs,
    eval_interval, metrics, seed, ...).
    """

    # --- model geometry -------------------------------------------------
    emb_dim: int = 64
    num_users: int = 128
    num_items: int = 128
    train_size: int = 128
    max_his: int = 8            # max user-history length (datasets.py:27)

    # --- loss / similarity ----------------------------------------------
    # Reference computes cosine similarity regardless of the YAML
    # `similarity_score: dot` label (matrix_factorization.cpp:91-95); both
    # are implemented here, cosine is the default for parity.
    similarity: str = "cosine"          # "cosine" | "dot"
    loss: str = "PairwiseLogisticLoss"  # "PairwiseLogisticLoss" | "CosineContrastiveLoss" | "SigmoidPairwiseLoss"
    temperature: float = 0.07   # score multiplier 1/0.07 (matrix_factorization.cpp:101)
    ccl_margin: float = 0.8     # CosineContrastiveLoss margin (SimpleX)
    ccl_neg_weight: float = 150.0  # CosineContrastiveLoss negative weight (SimpleX)

    # --- negative sampling ----------------------------------------------
    num_negs: int = 4
    neg_sampler: int = NEG_SAMPLER_UNIFORM
    tile_size: int = 1024       # RandomTileNegativeSampler tile (random_tile_negative_sampler.cpp:22-45); <= 0 auto-tunes (samplers.derive_tile_params — paper Alg. 1)
    refresh_interval: int = 2048
    ignore_pos: bool = True     # resample a draw that hits the positive
                                # (uniform_random_negative_sampler.cpp:26-36)

    # --- behavior aggregator --------------------------------------------
    # History pooling. The reference names "average pooling, self-attention,
    # and user-attention" (behavior_aggregators.cpp:27) but implements only
    # the mean; the attention variants (the paper's ACCL configurations) are
    # live here (models/aggregator.py pool_history).
    aggregator: str = "mean"    # "mean" | "self_attention" | "user_attention"
    gamma: float = 0.4          # user/history blend (behavior_aggregators.cpp:37,122)
    aggr_minibatch: int = 32    # weights0 update cadence (behavior_aggregators.cpp:32,141-146)
    # History-mean freshness. "step" recomputes each user's history mean
    # from the live item table every sample — the reference's semantics
    # (behavior_aggregators.cpp:96-105) — at the cost of H row reads per
    # sample (the dominant HBM traffic; each user is revisited ~epoch/U
    # times). "subepoch" precomputes a (U, d) means table once per
    # (sub-)epoch — a staleness-for-bandwidth trade in the same spirit as
    # HEAT's tile sampler, validated for accuracy parity in the tests.
    his_refresh: str = "step"   # "step" | "subepoch"

    # --- optimizer -------------------------------------------------------
    # The reference YAMLs carry `optimizer: sgd` and the engine hardcodes
    # SGD regardless (engine.cpp:16); here the key is honored, with
    # row-sparse Adagrad/Adam (lazy moments: only touched rows update) as
    # TPU-native extensions (scatter.apply_row_updates_opt).
    optimizer: str = "sgd"      # "sgd" | "adagrad" | "adam"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    opt_eps: float = 1.0e-8
    l_r: float = 1.0e-3
    clip_val: float = 0.1       # elementwise +-clip before SGD (optimizer.cpp:17-22)
    l2: float = 1.0e-3          # accepted for schema parity; the reference's
                                # l2 path is commented out (matrix_factorization.cpp:145-146,165,168)
    l2_enabled: bool = False    # opt-in: apply l2 to touched rows
    milestones: Sequence[int] = dataclasses.field(default_factory=list)
    lr_gamma: float = 0.1       # LR decay factor (engine.cpp:157-159)
    sgd_mode: str = SGD_MODE_BATCH
    # Row-update application. "dedup": combine duplicate ids per row, clip
    # the combined gradient, apply one update per unique row (the
    # reference's accum-path clip(accumulated row), optimizer.cpp:17-22).
    # "direct": scatter-add each occurrence's -lr*clip(g) straight into
    # the table — no f32 accumulator, no touched mask, no dense pass
    # (~25% off the headline step on v5e, scripts/profile_direct_update.py).
    # The clip applies per occurrence — which is the reference LIVE path's
    # own ordering (sparse_step clips each sample's gradient as it is
    # applied, sgd.cpp:14-26 called per sample from
    # matrix_factorization.cpp:147-174); where the clip binds on a
    # duplicated row the two modes genuinely differ (sum-of-clipped vs
    # clipped-sum). l2 likewise enters per occurrence. With bf16 tables
    # each occurrence's increment rounds separately (dedup rounds once
    # per unique row; both round the final bf16 subtraction either way).
    # End-metric parity validated at full scale
    # (scripts/accuracy_parity.py --modes direct:...). Batch-mode SGD only.
    update_mode: str = "dedup"  # "dedup" | "direct"

    # --- schedule ---------------------------------------------------------
    epochs: int = 1
    eval_interval: int = 2
    num_subepochs: int = 1      # item-column partitioning rounds per epoch
                                # (engine.cpp:108-121; reference default 2)
    # Negative-sampling scope in sub-epoch mode. "global" (default) draws
    # negatives from the FULL item space; "complement" constrains them to
    # the current partition's complement (the reference's written intent,
    # engine.cpp:222-238). Measured at AmazonBooks scale (DESIGN.md 6g),
    # complement at S=2 DOUBLES per-item negative pressure and collapses
    # training (Recall@20 0.0006 vs 0.0122 global / 0.0126 exact); the
    # reference's own implementation dodges this only because its
    # sub-epoch sampler degenerates to num_negs FIXED ids per half-epoch.
    # "complement" is kept for strict-parity studies and locality-
    # constrained model-parallel layouts.
    subepoch_neg_scope: str = "global"  # "global" | "complement"
    batch_size: int = 8192
    # Positive-sample order. "epoch": reshuffle every epoch (the upstream
    # OpenMP path's random_shuffle order, shuffle.hpp:13-48 — the published
    # HEAT results' behavior, and the safest SGD default). "once": shuffle
    # once, reuse the stream (no per-epoch shuffle cost). "none": parse
    # order — what the fork's LIVE MPI path actually does (its hot loop
    # engine.cpp:243-252 walks partition buckets in parse order; the
    # Shuffle object is only read by the commented-out OpenMP path).
    shuffle_mode: str = "epoch"  # "epoch" | "once" | "none"
    # Stable pre-sort of the visit stream before any shuffling (measured
    # at full scale, DESIGN.md 6h/6i — visit order is a TRAINING knob
    # for fixed streams, not just a perf one). "file": the parsed order
    # (reference semantics). "user": group clicks by user regardless of
    # file order — with shuffle_mode "none" this enables the
    # history-gather dedup speedups (exact mode 1.76 -> 1.00 s,
    # self-attention 1.85 -> 0.34 s) on ANY input file at a measured
    # few-% ranking cost (Recall@20 0.0122 vs 0.0126; "once" re-permutes
    # the individual pairs, which destroys the grouping the dedup
    # needs). "item": group by
    # item — the measured-best CosineContrastiveLoss order (0.0127 vs
    # 0.0102 shuffled; margin-active negatives appear every step), and
    # order-neutral for the pairwise loss (0.0126). Irrelevant under
    # shuffle_mode "epoch" (the per-epoch shuffle re-randomizes).
    visit_order: str = "file"  # "file" | "user" | "item"
    metrics: Sequence[str] = dataclasses.field(
        default_factory=lambda: ["Recall(k=20)"]
    )
    seed: int = 2022

    # --- precision --------------------------------------------------------
    param_dtype: str = "float32"   # embedding-table dtype
    compute_dtype: str = "float32"  # scoring-matmul dtype

    # --- physical layout --------------------------------------------------
    # Physical minor width of every d-wide state array (0 = emb_dim). At
    # huge tables (16M rows) full-sublane rows make XLA row scatters 2.2x
    # faster and gathers 1.25x faster than half-lane (N, 64) bf16 rows
    # (measured, scripts/profile_lane_width.py) — 3.08x end to end on the
    # 16M x 6M bench. COSTS REAL HBM: bf16 tables are stored compactly at
    # rest (128 B/row at width 64), so width 128 DOUBLES table bytes. At
    # 91.6k-row tables it is also a ~1.4x scatter LOSS — a huge-table
    # knob, not a default. The pad columns are provably zero through
    # every update: all row reads carry zero tails, so every gradient,
    # moment, and l2 term has a zero tail, and w0's pad rows/cols stay
    # zero under its outer-product gradient. Math is therefore IDENTICAL
    # to the unpadded model.
    emb_pad: int = 0

    def __post_init__(self) -> None:
        if self.similarity not in ("cosine", "dot"):
            raise ValueError(f"unknown similarity {self.similarity!r}")
        if self.sgd_mode not in (SGD_MODE_BATCH, SGD_MODE_ACCUM):
            raise ValueError(f"unknown sgd_mode {self.sgd_mode!r}")
        if self.loss not in (
            "PairwiseLogisticLoss",
            "CosineContrastiveLoss",
            "SigmoidPairwiseLoss",
        ):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.his_refresh not in ("step", "subepoch"):
            raise ValueError(f"unknown his_refresh {self.his_refresh!r}")
        if self.subepoch_neg_scope not in ("global", "complement"):
            raise ValueError(
                f"unknown subepoch_neg_scope {self.subepoch_neg_scope!r}"
            )
        if self.shuffle_mode not in ("epoch", "once", "none"):
            raise ValueError(f"unknown shuffle_mode {self.shuffle_mode!r}")
        if self.visit_order not in ("file", "user", "item"):
            raise ValueError(f"unknown visit_order {self.visit_order!r}")
        if (
            self.loss == "CosineContrastiveLoss"
            and self.shuffle_mode == "none"
            # Sub-epoch mode re-buckets the stream by item partition —
            # the measured-SAFE (item-grouped) visiting the warning text
            # itself recommends; visit_order="item" requests exactly
            # that order, so it is the fix, not the hazard.
            and self.num_subepochs <= 1
            and self.visit_order != "item"
        ):
            # Measured full-scale hazard (DESIGN.md 6h): real click files
            # are user-grouped, and user-grouped visiting under the
            # margin loss compounds consecutive same-user updates —
            # Recall@20 collapses 0.0102 -> 0.0015. Warn, don't raise:
            # an item-grouped stream is legitimate (0.0127).
            import warnings

            warnings.warn(
                "loss=CosineContrastiveLoss with shuffle_mode='none': "
                "user-grouped parse-order streams measurably collapse "
                "CCL training (Recall@20 0.0015 vs 0.0102 shuffled, "
                "DESIGN.md 6h). Use the default shuffle_mode='epoch', "
                "sub-epoch mode, or visit_order='item' (the "
                "measured-best CCL order, 0.0127).",
                stacklevel=2,
            )
        if self.aggregator not in ("mean", "self_attention", "user_attention"):
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if self.aggregator == "self_attention" and self.his_refresh != "step":
            # Under cached pooling the pooled history is stop_gradient'ed,
            # and pooling is attn_q's ONLY gradient path — the query would
            # silently stay frozen at its random init. (user_attention is
            # fine: its query is the user row, which still trains through
            # the scoring path; only the attention weights go stale, which
            # is the caching mode's documented contract.)
            raise ValueError(
                "aggregator='self_attention' requires his_refresh='step': "
                "with cached pooling the learned attention query receives "
                "no gradient and never trains"
            )
        self.optimizer = str(self.optimizer).lower()
        if self.optimizer not in ("sgd", "adagrad", "adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.optimizer != "sgd" and self.sgd_mode == SGD_MODE_ACCUM:
            raise ValueError(
                "sgd_mode='accum' replicates the reference's persistent "
                "SGD gradient rows and is only defined for optimizer='sgd'"
            )
        if self.update_mode not in ("dedup", "direct"):
            raise ValueError(f"unknown update_mode {self.update_mode!r}")
        if self.update_mode == "direct" and (
            self.optimizer != "sgd" or self.sgd_mode != SGD_MODE_BATCH
        ):
            raise ValueError(
                "update_mode='direct' is plain per-occurrence SGD; it is "
                "only defined for optimizer='sgd' with sgd_mode='batch' "
                "(accum mode and moment-based optimizers must combine "
                "duplicate rows first)"
            )
        if self.emb_pad and self.emb_pad < self.emb_dim:
            raise ValueError(
                f"emb_pad ({self.emb_pad}) must be >= emb_dim "
                f"({self.emb_dim}) (or 0 to disable)"
            )
        # emb_pad composes with every aggregator since round 5: the
        # attention softmax scales by the LOGICAL width (pool_history's
        # logical_dim) and attn_q pads with a provably-zero tail, so the
        # math is identical to the unpadded model (tested:
        # tests/test_engine.py emb_pad attention identity).
        self.milestones = list(self.milestones)
        self.metrics = list(self.metrics)

    # -- derived -----------------------------------------------------------
    @property
    def score_mul(self) -> float:
        """Inverse temperature applied to score differences."""
        return 1.0 / self.temperature


# YAML model_config key -> CFConfig field (reference main.py:40-44 mapping).
_MODEL_KEY_MAP = {
    "embedding_dim": "emb_dim",
    "num_negs": "num_negs",
    "max_his": "max_his",
    "neg_sampler": "neg_sampler",
    "tile_size": "tile_size",
    "refresh_interval": "refresh_interval",
    "embedding_regularizer": "l2",
    "clip_val": "clip_val",
    "milestones": "milestones",
    "learning_rate": "l_r",
    "loss": "loss",
    "metrics": "metrics",
    "epochs": "epochs",
    "eval_interval": "eval_interval",
    "seed": "seed",
    "batch_size": "batch_size",
    "num_subepochs": "num_subepochs",
    "num_subepoches": "num_subepochs",  # reference spelling (cf_config.py:8)
    "subepoch_neg_scope": "subepoch_neg_scope",
    "sgd_mode": "sgd_mode",
    "update_mode": "update_mode",
    "shuffle_mode": "shuffle_mode",
    "visit_order": "visit_order",
    "his_refresh": "his_refresh",
    "aggregator": "aggregator",
    "aggregation": "aggregator",  # SimpleX config spelling
    "optimizer": "optimizer",
    "adam_beta1": "adam_beta1",
    "adam_beta2": "adam_beta2",
    "opt_eps": "opt_eps",
    "gamma": "gamma",
    "temperature": "temperature",
    "param_dtype": "param_dtype",
    "compute_dtype": "compute_dtype",
}

# Keys present in reference YAMLs that the reference itself never consumes
# (SURVEY.md section 5 "Config / flag system"); accepted and dropped with a
# deliberate allowlist rather than silently.
_IGNORED_MODEL_KEYS = {
    "embedding_dropout",
    "net_regularizer",
    "net_dropout",
}

# `similarity_score: dot` in reference YAMLs is a mislabel — the kernel
# computes cosine (matrix_factorization.cpp:91-95). Accept the key but keep
# cosine unless explicitly overridden via `similarity`.
_SIMILARITY_KEYS = {"similarity_score", "similarity"}


@dataclasses.dataclass
class DatasetConfig:
    """dataset_config block of the reference YAML schema."""

    data_dir: str = ""
    train_data: str = "train.txt"
    test_data: str = "test.txt"
    separator: str = " "
    data_format: str = "txt"


def _resolve_model_key(key: str) -> str | None:
    """YAML/override key -> CFConfig field name (None = accepted-and-ignored).

    Raises KeyError for keys that are neither reference-schema YAML keys,
    deliberately-ignored reference keys, nor CFConfig field names.
    """
    if key in _MODEL_KEY_MAP:
        return _MODEL_KEY_MAP[key]
    if key in _SIMILARITY_KEYS:
        # `similarity_score: dot` is the reference YAMLs' mislabel (the
        # kernel computes cosine); only the explicit `similarity` key binds.
        return "similarity" if key == "similarity" else None
    if key in _IGNORED_MODEL_KEYS:
        return None
    if key in {f.name for f in dataclasses.fields(CFConfig)}:
        return key
    raise KeyError(f"unknown model_config key {key!r}")


def config_from_dicts(
    model_config: dict[str, Any], overrides: dict[str, Any] | None = None
) -> CFConfig:
    """Build a CFConfig from a reference-schema model_config dict.

    Overrides go through the same key handling as the YAML keys (either
    YAML names or CFConfig field names bind; reference-ignored keys are
    accepted and dropped; anything else raises KeyError).
    """
    kwargs: dict[str, Any] = {}
    for source in (model_config, overrides or {}):
        for key, value in source.items():
            field = _resolve_model_key(key)
            if field is not None:
                kwargs[field] = value
    return CFConfig(**kwargs)


def load_config(path: str, **overrides: Any) -> tuple[CFConfig, DatasetConfig]:
    """Load a reference-format YAML config file.

    Returns (CFConfig, DatasetConfig). Equivalent to utils.load_config +
    the CFConfig construction in main.py:34-44.
    """
    with open(path, "r") as fh:
        config_dic = yaml.safe_load(fh)
    dataset_dic = config_dic.get("dataset_config", {})
    model_dic = config_dic.get("model_config", {})
    dataset_config = DatasetConfig(
        **{
            k: v
            for k, v in dataset_dic.items()
            if k in {f.name for f in dataclasses.fields(DatasetConfig)}
        }
    )
    return config_from_dicts(model_dic, overrides), dataset_config
