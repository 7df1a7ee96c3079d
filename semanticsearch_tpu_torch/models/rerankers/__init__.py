"""The rerankers of ``semanticsearch_tpu/models/rerankers`` as
``torch.nn.Module``s: (left_ids, right_ids) -> (B,) scores."""
from .base import MODEL_REGISTRY, get_model_class, make_model
from .knrm import KNRM, ConvKNRM
from .conv2d_models import ArcII, MatchPyramid
from .cross_encoder import CrossEncoder, transfer_from_encoder
from .recurrent import ESIM, MVLSTM, MatchLSTM

__all__ = [
    "MODEL_REGISTRY",
    "get_model_class",
    "make_model",
    "KNRM",
    "ConvKNRM",
    "ArcII",
    "MatchPyramid",
    "ESIM",
    "MVLSTM",
    "MatchLSTM",
    "CrossEncoder",
    "transfer_from_encoder",
]
