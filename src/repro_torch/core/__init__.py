"""Spatio-temporal split learning in the port, as ``repro.core``:

- session:  ``SplitSession`` over the fused (scan / stepwise), looped
            reference, queue (protocol-async / fused-queue), FedAvg and
            ``llm-split`` engines, with one canonical state
- trainer:  the fused trainer, the looped reference, the queue engines'
            server step and bank replay, evaluation
- adapters: the model adapters and their banked (per-client) views
- queue:    the server-side feature queue (paper Fig. 1) and the
            FeatureBank that stages arrivals for the fused-queue engine
- protocol: the two-program client/server protocol and fleet production
- faults:   deterministic fault injection (FaultPlan) for the queue
            engines, via ``fit(..., faults=)``
- fedavg:   the federated-learning baseline the paper compares against
- distributed: multi-client split learning over the attention-only LM
            configs (the ``llm-split`` engine's step)

The privacy subsystem (the guard, the accountant, the inversion audit)
lives in ``repro_torch.privacy``; ``core.dp`` and ``core.inversion`` are
deprecated shims over it.
"""
from repro_torch.core.faults import ClientLoopError, FaultPlan
from repro_torch.core.fedavg import train_fedavg
from repro_torch.core.queue import FeatureBank, FeatureQueue
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
    make_server_bank_runner,
    make_spatio_temporal_step,
    single_client_config,
)
from repro_torch.privacy.guard import DPConfig, PrivacyGuard
