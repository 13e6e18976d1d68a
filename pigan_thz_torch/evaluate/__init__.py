from .evaluator import Evaluator

__all__ = ["Evaluator"]
