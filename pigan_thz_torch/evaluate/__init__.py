from .ceilings import noise_ceilings, oracle_validation
from .evaluator import Evaluator
from .report import generate_summary_report
from .rubrics import (
    SUITE_RUBRICS,
    rubric_forward,
    rubric_pigan,
    rubric_structural,
    rubric_validation,
)

__all__ = [
    "Evaluator",
    "generate_summary_report",
    "noise_ceilings",
    "oracle_validation",
    "SUITE_RUBRICS",
    "rubric_forward",
    "rubric_pigan",
    "rubric_structural",
    "rubric_validation",
]
