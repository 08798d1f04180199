from .optimizer import Optimizer, adam, apply_updates, make_optimizer, sgd

__all__ = ["Optimizer", "apply_updates", "sgd", "adam", "make_optimizer"]
