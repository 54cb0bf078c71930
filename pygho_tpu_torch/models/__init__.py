from .serve import SpPredictor
from .training import (cosine_warm_restarts, make_optimizer,
                       make_sparse_steps, masked_l1_loss)
from .zinc import InputEncoderSp, SpModel, make_sp_model

__all__ = ["InputEncoderSp", "SpModel", "SpPredictor",
           "cosine_warm_restarts", "make_optimizer", "make_sp_model",
           "make_sparse_steps", "masked_l1_loss"]
