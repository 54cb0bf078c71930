from .serve import SpPredictor
from .zinc import InputEncoderSp, SpModel, make_sp_model

__all__ = ["InputEncoderSp", "SpModel", "SpPredictor", "make_sp_model"]
