"""Policy serving (counterpart of `actor_critic_tpu/serving/`): the acting
path as an inference service — GA3C-style micro-batching (arxiv
1611.06256) over stdlib HTTP, one CUDA graph per act bucket on the card,
multi-policy hot swap, serving metrics on /metrics.
`python -m actor_critic_tpu_torch.serve` is the CLI, and
`python -m actor_critic_tpu_torch.train ... --async-actors N --serve-port
P` serves the learner while it trains.

`FleetProxy` fronts N replicas (`python -m actor_critic_tpu_torch.serve_fleet`),
and `MailboxPolicySyncer` swaps a rank's mailbox snapshots into a replica
(`serve --sync-mailbox`).
"""

from actor_critic_tpu_torch.serving.batcher import (
    DispatcherDown,
    MicroBatcher,
    Overloaded,
    QueueFull,
    ServingMetrics,
)
from actor_critic_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    PolicyEngine,
    init_params,
    make_act_program,
)
from actor_critic_tpu_torch.serving.fleet_proxy import (
    FleetProxy,
    MailboxPolicySyncer,
    NoHealthyReplica,
)
from actor_critic_tpu_torch.serving.gateway import ServeGateway, standalone_metrics
from actor_critic_tpu_torch.serving.policy_store import (
    PolicyHandle,
    PolicyStore,
    UnknownPolicy,
    export_policy_params,
    restore_policy_params,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DispatcherDown",
    "FleetProxy",
    "MailboxPolicySyncer",
    "NoHealthyReplica",
    "MicroBatcher",
    "Overloaded",
    "PolicyEngine",
    "PolicyHandle",
    "PolicyStore",
    "QueueFull",
    "ServeGateway",
    "ServingMetrics",
    "UnknownPolicy",
    "export_policy_params",
    "init_params",
    "make_act_program",
    "restore_policy_params",
    "standalone_metrics",
]
