from .optimizer import (AdafactorState, AdamState, Optimizer, adafactor, adam, adamw,
                        apply_updates, chain, clip_by_global_norm, global_norm,
                        make_optimizer, momentum, sgd)
from .train_step import make_prefill_step, make_serve_step, make_train_step

__all__ = ["Optimizer", "AdamState", "AdafactorState", "apply_updates", "sgd", "momentum",
           "adam", "adamw", "adafactor", "clip_by_global_norm", "chain", "global_norm",
           "make_optimizer", "make_train_step", "make_prefill_step", "make_serve_step"]
