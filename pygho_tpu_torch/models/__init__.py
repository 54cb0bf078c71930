from .serve import MaPredictor, SpPredictor
from .training import (cosine_warm_restarts, make_dense_steps,
                       make_optimizer, make_sparse_steps, masked_l1_loss)
from .zinc import (InputEncoderMa, InputEncoderSp, MaModel, SpModel,
                   make_ma_model, make_sp_model)

__all__ = ["InputEncoderMa", "InputEncoderSp", "MaModel", "MaPredictor",
           "SpModel", "SpPredictor", "cosine_warm_restarts",
           "make_dense_steps", "make_ma_model", "make_optimizer",
           "make_sp_model", "make_sparse_steps", "masked_l1_loss"]
