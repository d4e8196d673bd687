"""Predict and decode serving: the bucketed engine and its replicas, the
dynamic batcher, checkpoint hot reload, the multi-model fleet under a
memory budget, the continuous-batching decode engine with its prefix
index, and the tiered KV cache behind it (host RAM and disk records)."""

from ..runtime.faults import (DeadlineExceededError,
                              DecodePagesExhaustedError,
                              DecodeSlotsExhaustedError,
                              KVCorruptRecordError, KVSpillError,
                              KVTierError, MemoryBudgetExceededError,
                              RequestAbandonedError, ServeError,
                              ServeOverloadError, TokenDeadlineExceededError)
from .batcher import DynamicBatcher, ServeRequest
from .decode import (LM_PATTERN, DecodeEngine, DecodeService, lm_loader,
                     load_lm_params, save_lm_params)
from .engine import PredictEngine, ReplicatedPredictEngine
from .kvcache import TieredKVCache
from .kvstore import KVStore
from .registry import (MemoryBudgeter, ModelRegistry, MultiModelRegistry,
                       load_model_params)

__all__ = ['PredictEngine', 'ReplicatedPredictEngine', 'DynamicBatcher',
           'ServeRequest',
           'ModelRegistry', 'MultiModelRegistry', 'MemoryBudgeter',
           'load_model_params', 'DecodeEngine', 'DecodeService',
           'save_lm_params', 'load_lm_params', 'lm_loader', 'LM_PATTERN',
           'ServeError', 'ServeOverloadError', 'DeadlineExceededError',
           'TokenDeadlineExceededError', 'DecodeSlotsExhaustedError',
           'DecodePagesExhaustedError', 'MemoryBudgetExceededError',
           'RequestAbandonedError', 'TieredKVCache', 'KVStore',
           'KVTierError', 'KVCorruptRecordError', 'KVSpillError']
