"""Single-process control plane (SURVEY.md §2.1): state store, eval broker,
blocked evals, plan queue/applier, scheduling workers, heartbeats."""
from .blocked import BlockedEvals
from .broker import EvalBroker
from .plan_apply import PlanApplier, PlanQueue, evaluate_node_plan
from .server import Server, ServerConfig
from .state import StateSnapshot, StateStore
from .worker import Worker

__all__ = [
    "BlockedEvals",
    "EvalBroker",
    "PlanApplier",
    "PlanQueue",
    "evaluate_node_plan",
    "Server",
    "ServerConfig",
    "StateSnapshot",
    "StateStore",
    "Worker",
]
