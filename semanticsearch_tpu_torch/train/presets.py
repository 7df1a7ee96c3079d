"""Per-model presets: the port's copy of
``semanticsearch_tpu/train/presets.py``.

Each reranker's ``TrainConfig`` and model keyword arguments, the reference's
chosen hyperparameters (``MatchZoo_Tool/train_controller.py:46-188``). They
are pure configuration; serving reads the widths from them (embedding
width, sequence lengths, the models' own widths).
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..core.config import TrainConfig

# (TrainConfig, model_kwargs) per model key.
MODEL_TRAIN_PRESETS: Dict[str, Tuple[TrainConfig, dict]] = {
    "knrm": (
        TrainConfig(
            model="knrm", optimizer="adadelta", learning_rate=1.0,
            batch_size=64, num_dup=1, num_neg=1, loss="hinge",
            fixed_length_left=16, fixed_length_right=64, filter_low_freq=5,
        ),
        {"kernel_num": 21, "sigma": 0.1, "exact_sigma": 0.001},
    ),
    "conv_knrm": (
        TrainConfig(
            model="conv_knrm", optimizer="adadelta", learning_rate=1.0,
            batch_size=32, num_dup=1, num_neg=1, loss="hinge",
            clip_norm=10.0,
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
        ),
        {"filters": 128, "max_ngram": 3, "use_crossmatch": True,
         "kernel_num": 11, "sigma": 0.1, "exact_sigma": 0.001},
    ),
    "arcii": (
        TrainConfig(
            model="arcii", optimizer="adam", learning_rate=1e-3,
            batch_size=64, num_dup=1, num_neg=1, loss="hinge",
            fixed_length_left=16, fixed_length_right=256, filter_low_freq=5,
        ),
        {"kernel_1d_count": 32, "kernel_1d_size": 3,
         "kernel_2d_count": (64, 64), "dropout_rate": 0.3},
    ),
    "esim": (
        TrainConfig(
            model="esim", optimizer="adadelta", learning_rate=1.0,
            batch_size=32, num_dup=1, num_neg=1, loss="rank_xent",
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
        ),
        {"hidden_size": 200, "dropout_rate": 0.2},
    ),
    "match_lstm": (
        TrainConfig(
            model="match_lstm", optimizer="adadelta", learning_rate=1.0,
            batch_size=32, num_dup=1, num_neg=1, loss="rank_xent",
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
        ),
        {},
    ),
    "match_pyramid": (
        TrainConfig(
            model="match_pyramid", optimizer="adam", learning_rate=1e-3,
            batch_size=64, num_dup=1, num_neg=1, loss="hinge",
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
        ),
        {"kernel_count": (16, 32), "dpool_size": (3, 10), "dropout_rate": 0.3},
    ),
    "mvlstm": (
        TrainConfig(
            model="mvlstm", optimizer="adadelta", learning_rate=1.0,
            batch_size=32, num_dup=1, num_neg=1, loss="rank_xent",
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
        ),
        {"hidden_size": 128, "top_k": 10},
    ),
    # beyond the reference's seven: the cross-encoder, meant to start from
    # a trained sentence encoder (models/rerankers/cross_encoder.py::
    # transfer_from_encoder), hence the low learning rate
    "cross_encoder": (
        TrainConfig(
            model="cross_encoder", optimizer="adam", learning_rate=2e-4,
            batch_size=32, num_dup=1, num_neg=4, loss="rank_xent",
            fixed_length_left=16, fixed_length_right=128, filter_low_freq=5,
            embedding_dim=128,
        ),
        {"num_layers": 2, "num_heads": 4, "mlp_dim": 256,
         "dropout_rate": 0.1},
    ),
}


def get_preset(model_name: str) -> Tuple[TrainConfig, dict]:
    key = model_name.lower().replace("-", "_")
    if key not in MODEL_TRAIN_PRESETS:
        raise KeyError(
            f"no preset for {model_name!r}; have {sorted(MODEL_TRAIN_PRESETS)}"
        )
    cfg, kwargs = MODEL_TRAIN_PRESETS[key]
    return cfg, dict(kwargs)
