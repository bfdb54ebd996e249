"""Spatio-temporal split learning in the port, as ``repro.core``:

- session:  ``SplitSession`` over the fused (scan / stepwise) and looped
            reference engines, with one canonical state
- trainer:  the fused trainer, the looped reference, evaluation
- adapters: the model adapters and their banked (per-client) views
- queue, protocol: the feature queue and the client-side release that
            serving needs
"""
from repro_torch.core.queue import FeatureQueue
from repro_torch.core.session import SplitSession, available_engines, register_engine
from repro_torch.core.trainer import (
    SamplePlan,
    SplitTrainConfig,
    device_put_shards,
    evaluate,
    evaluate_per_client,
    make_epoch_runner,
    make_looped_step,
    make_sample_plan,
    make_spatio_temporal_step,
    single_client_config,
)
from repro_torch.privacy.guard import DPConfig, PrivacyGuard
