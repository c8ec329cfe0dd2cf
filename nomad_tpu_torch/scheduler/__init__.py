"""Scheduler package of the port: reconciler, generic and system
schedulers, the torch stack, scalar oracle (reference `scheduler/`)."""
from .stack import PlanContext, SelectResult, TorchStack  # noqa: F401
