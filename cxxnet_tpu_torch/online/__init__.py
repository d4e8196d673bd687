"""Train-while-serve: the online-learning subsystem.

The port's own copy of ``cxxnet_tpu/online/``.  ``OnlinePipeline`` runs a
long-lived supervised trainer and a colocated serving stack as ONE
process: the trainer publishes ``%04d.model`` checkpoints every N steps
(on the background writer), a ``ModelRegistry``-backed ``PredictEngine``
watches the same directory and hot-swaps them under live traffic, and a
``FreshnessTracker`` measures the step-to-serving lag of every swap
against a configurable SLO.
"""

from .freshness import FreshnessTracker
from .pipeline import OnlineConfig, OnlinePipeline

__all__ = ['FreshnessTracker', 'OnlineConfig', 'OnlinePipeline']
