"""Steps: the inference step (training comes with the training slice)."""

from tpuframe_torch.train.step import make_predict_fn

__all__ = ["make_predict_fn"]
