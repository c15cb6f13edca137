"""Experiment orchestration: trial runner (tune), analysis, suites
(counterpart of multimodal_dmm_tpu/experiments)."""

from . import tune
from .analysis import ExperimentAnalysis
