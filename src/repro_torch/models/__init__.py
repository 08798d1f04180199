from .small import (CifarCNN, MnistMLP, SmallModel, Sst2Text, get_small_model,
                    params_from_jax)

__all__ = ["SmallModel", "MnistMLP", "CifarCNN", "Sst2Text",
           "get_small_model", "params_from_jax"]
